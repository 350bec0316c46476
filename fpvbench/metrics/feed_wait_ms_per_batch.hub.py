"""Milliseconds a batch of the client blocked on a full input queue of the hub
(in ``feed`` and ``end_stream``): the hub's workers, not the client, set the
pace.  Read from the hub's counter ``feed_wait_s``
(``MultiStreamDecoder.stats``; ``hub.feed_wait_s`` in the entry's counts)
over the batches handed to the finalize worker in the same span
(``hub.batches``, each stream's frame 0 included).  A counter, not a span:
the hub's workers run on threads of their own, which the benchmark's
profiler does not record."""


def read(reading):
    batches = reading.counts.get("hub.batches", 0)
    if not batches or "hub.feed_wait_s" not in reading.counts:
        return None
    return 1e3 * reading.counts["hub.feed_wait_s"] / batches

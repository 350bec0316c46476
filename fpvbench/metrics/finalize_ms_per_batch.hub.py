"""Milliseconds a batch of the hub's finalize worker in a batch's
``finalize`` (the wait for its device work, the download, the integrity
checks) and the sink.  Read from the hub's counter ``finalize_s``
(``MultiStreamDecoder.stats``; ``hub.finalize_s`` in the entry's counts)
over the batches handed to the finalize worker in the same span
(``hub.batches``, each stream's frame 0 included).  A counter, not a span:
the hub's workers run on threads of their own, which the benchmark's
profiler does not record."""


def read(reading):
    batches = reading.counts.get("hub.batches", 0)
    if not batches or "hub.finalize_s" not in reading.counts:
        return None
    return 1e3 * reading.counts["hub.finalize_s"] / batches

"""Device time per batch section decoded in the window, in milliseconds:
the seconds in which some kernel, memcpy or memset ran on the card (work
on two streams at once counts once) over the batches.  The host's share
of a decode is left out, so a change to the kernels or the device tail
shows here without the host's swing between runs."""


def read(reading):
    batches = reading.counts.get("batches", 0)
    if not batches or not reading.trace.device:
        return None
    return 1e3 * reading.trace.busy_s() / batches

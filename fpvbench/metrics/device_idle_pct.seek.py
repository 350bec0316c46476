"""Share of the measured window in which no kernel, memcpy or memset ran
on the card, in percent (the profiler's timeline; work on two streams at
once counts once)."""


def read(reading):
    tr = reading.trace
    if tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)

"""K2 launches in the window per single-frame request (one a frame walked
back along the prev-frame chain)."""

from fpvbench import bytecount


def read(reading):
    requests = reading.counts.get("requests", 0)
    if not requests or not reading.trace.device:
        return None
    return len(reading.trace.kernels(bytecount.K2_KERNELS)) / requests

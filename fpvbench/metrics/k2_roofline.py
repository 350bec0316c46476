"""K2's share of its roofline, in percent: the bytes K2 must move for the
coded main-plane streams the window decoded (fpvbench/bytecount.py) at the
card's peak bandwidth, over its device time in the trace."""

from fpvbench import bytecount


def read(reading):
    t = sum(k.end - k.start for k in reading.trace.kernels(
        bytecount.K2_KERNELS))
    return bytecount.roofline_pct(reading.counts.get("k2_bytes", 0), t)

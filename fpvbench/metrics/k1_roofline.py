"""K1's share of its roofline, in percent: the bytes K1a and K1b must
move for the streams the window wrote (fpvbench/bytecount.py, payload
words read from the files) at the card's peak bandwidth, over the two
kernels' device time in the trace."""

from fpvbench import bytecount


def read(reading):
    t = sum(k.end - k.start for k in reading.trace.kernels(
        bytecount.K1_KERNELS))
    return bytecount.roofline_pct(reading.counts.get("k1_bytes", 0), t)

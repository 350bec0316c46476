"""Milliseconds a batch section decoded in the window in which the card
was idle inside the program span ``fpvt.read.finalize`` (the finalize of
one batch: the wait on the copy stream, the download into pinned memory,
the integrity check), the innermost program span open then
(fpvbench/spans.py)."""

from fpvbench import spans


def read(reading):
    return spans.idle_per(reading, "pass", "fpvt.read.finalize", "batches")

"""Milliseconds a batch section decoded in the window in which the card
was idle inside the program span ``fpvt.read.assemble`` (the assembly of
a file's frames: frame 0, the concatenation and the dtype cast), the
innermost program span open then (fpvbench/spans.py)."""

from fpvbench import spans


def read(reading):
    return spans.idle_per(reading, "pass", "fpvt.read.assemble", "batches")

"""Milliseconds a single-frame request in which the card was idle inside
the program span ``fpvt.read.chain`` (one frame of the prev chain
walked: its arguments, upload, K2 launch, inverse prediction and add),
the innermost program span open then (fpvbench/spans.py)."""

from fpvbench import spans


def read(reading):
    return spans.idle_per(reading, "request", "fpvt.read.chain", "requests")

"""Milliseconds a single-frame request in which the card was idle inside
the program span ``fpvt.read.parse`` (the parse of the frame's batch
section), the innermost program span open then (fpvbench/spans.py)."""

from fpvbench import spans


def read(reading):
    return spans.idle_per(reading, "request", "fpvt.read.parse", "requests")

"""Milliseconds a batch section decoded in the window in which the card
was idle inside the program span ``fpvt.read.parse`` (the parse of one
batch section: its payload copies and checks), the innermost program
span open then (fpvbench/spans.py)."""

from fpvbench import spans


def read(reading):
    return spans.idle_per(reading, "pass", "fpvt.read.parse", "batches")

"""Milliseconds a batch section decoded in the window in which the card
was idle inside the program span ``fpvt.read.dispatch`` (the dispatch of
one batch: queueing K2, the inverse predictions, the temporal add, the
combine), the innermost program span open then (fpvbench/spans.py)."""

from fpvbench import spans


def read(reading):
    return spans.idle_per(reading, "pass", "fpvt.read.dispatch", "batches")

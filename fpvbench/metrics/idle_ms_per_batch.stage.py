"""Milliseconds a batch section decoded in the window in which the card
was idle inside the program span ``fpvt.read.stage`` (the staging of one
batch: pinned host buffers and the queued uploads), the innermost
program span open then (fpvbench/spans.py)."""

from fpvbench import spans


def read(reading):
    return spans.idle_per(reading, "pass", "fpvt.read.stage", "batches")

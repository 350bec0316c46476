"""Milliseconds a batch section decoded in the window in which the card
was idle inside the program span ``fpvt.read.open`` (the reader's open:
the header, the copy of the file's bytes, the footer parse and checks,
the frame index and the delta section's decode), the innermost program
span open then (fpvbench/spans.py)."""

from fpvbench import spans


def read(reading):
    return spans.idle_per(reading, "pass", "fpvt.read.open", "batches")

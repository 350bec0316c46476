"""Milliseconds a single-frame request in which the card was idle inside
the program span ``fpvt.read.download`` (the answer's combine, copy to
the host and view), the innermost program span open then
(fpvbench/spans.py)."""

from fpvbench import spans


def read(reading):
    return spans.idle_per(reading, "request", "fpvt.read.download",
                          "requests")

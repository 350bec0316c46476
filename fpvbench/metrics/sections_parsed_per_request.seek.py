"""Batch sections parsed in the window per single-frame request: the
``fpvt.read.parse`` spans that start in it (fpvbench/spans.py), over the
requests. Silent without device activity, as the other trace readers."""

from fpvbench import spans


def read(reading):
    requests = reading.counts.get("requests", 0)
    tr = reading.trace
    if not requests or not tr.device or not spans.program_spans(tr):
        return None
    return spans.count(tr, "fpvt.read.parse") / requests

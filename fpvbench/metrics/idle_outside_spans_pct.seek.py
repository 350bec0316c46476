"""Share of the card's idle time under the ``request`` spans (one
``decode_frame`` each) that falls under no program span, in percent: the
reader's code that no ``fpvt.*`` span covers (fpvbench/spans.py)."""

from fpvbench import spans


def read(reading):
    return spans.outside_pct(reading, "request")

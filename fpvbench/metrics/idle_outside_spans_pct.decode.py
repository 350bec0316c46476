"""Share of the card's idle time under the ``pass`` spans (one
whole-file decode each) that falls under no program span, in percent: the
reader's code that no ``fpvt.*`` span covers (fpvbench/spans.py)."""

from fpvbench import spans


def read(reading):
    return spans.outside_pct(reading, "pass")

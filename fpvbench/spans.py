"""The program's own spans in a traced window, and the card's idle time
charged to them.

The codec opens a named profiler range at the boundary of each host stage
(``fpv_tpu_torch.utils.profiling.annotate``), so its ranges lie in the
same profiler trace as the kernels they launch, on the same clock, among
the host spans (they have no copy on the card's timeline).
Their names start with :data:`PREFIX` (``fpvt.read.parse``,
``fpvt.write.serialize``, ...): that is how they are told from aten ops
and from the benchmark's own ``window``, ``pass`` and ``request`` spans.

Every idle instant of the card under a call span of the window's thread
is charged to the innermost program span open at that instant on that
thread, or to no span ("outside"): exact interval intersection, so the
charges add up to the idle time under the call spans.  A trace of a
program without such spans holds none, and every reader built on this
returns None.
"""

from __future__ import annotations

from collections import defaultdict

from fpvbench.trace import WINDOW, Trace, innermost

PREFIX = "fpvt."
OUTSIDE = None  # the key of idle time under no program span


def _on_thread(tr: Trace, keep) -> list:
    """The host spans of the window's thread that overlap the window and
    whose name passes ``keep``, sorted by start (an enclosing span before
    one that starts at the same instant)."""
    w0, w1 = tr.window
    mains = [h for h in tr.host if h.name == WINDOW]
    thread = max(mains, key=lambda h: h.end - h.start).thread if mains else 0
    return sorted((h for h in tr.host if h.thread == thread and keep(h.name)
                   and h.end > w0 and h.start < w1),
                  key=lambda h: (h.start, -h.end))


def program_spans(tr: Trace) -> list:
    """The program's spans on the window's thread, sorted by start."""
    return _on_thread(tr, lambda name: name.startswith(PREFIX))


def count(tr: Trace, name: str) -> int:
    """How many spans called ``name`` start inside the window."""
    w0, w1 = tr.window
    return sum(1 for h in program_spans(tr)
               if h.name == name and w0 <= h.start < w1)


def _union(pieces) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(pieces):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _intersect(xs, ys) -> list[tuple[float, float]]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_by_span(tr: Trace, call: str) -> dict | None:
    """Seconds the card was idle under the spans named ``call`` (the
    benchmark's span around each call), by the innermost program span
    open at each instant: ``{span name: s, OUTSIDE: s}``.  None when the
    trace holds no device activity or no program span."""
    if not tr.device:
        return None
    prog = program_spans(tr)
    if not prog:
        return None
    calls = _union((max(h.start, tr.window[0]), min(h.end, tr.window[1]))
                   for h in _on_thread(tr, lambda name: name == call))
    idle = _intersect(tr.idle_gaps(), calls)
    # the instants at which the innermost program span can change, and the
    # innermost one over each piece between two of them
    cuts = sorted({t for h in prog for t in (h.start, h.end)}
                  | {a for a, _ in idle} | {b for _, b in idle})
    pieces = list(zip(cuts, cuts[1:]))
    owners = innermost(prog, [(a + b) / 2 for a, b in pieces])
    out: dict = defaultdict(float)
    j = 0
    for (a, b), owner in zip(pieces, owners):
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        if j < len(idle) and idle[j][0] <= a and b <= idle[j][1]:
            out[owner.name if owner else OUTSIDE] += b - a
    return dict(out)


def idle_per(reading, call: str, stage: str, per: str) -> float | None:
    """Milliseconds of idle card charged to the program span ``stage``
    under ``call`` spans, per unit of ``reading.counts[per]``."""
    n = reading.counts.get(per, 0)
    idle = idle_by_span(reading.trace, call)
    if not n or idle is None:
        return None
    return 1e3 * idle.get(stage, 0.0) / n


def outside_pct(reading, call: str) -> float | None:
    """Share of the card's idle time under ``call`` spans that falls under
    no program span, in percent: program code that no span covers."""
    idle = idle_by_span(reading.trace, call)
    if idle is None:
        return None
    total = sum(idle.values())
    return 100.0 * idle.get(OUTSIDE, 0.0) / total if total > 0 else None

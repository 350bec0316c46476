"""The traced run: torch.profiler over the measured window, reduced in
memory to what the per-layer metrics and the breakdown read.

The benchmark opens ``record_function`` spans of its own: ``window``
around the whole measured loop, and one around each call, named by the
cell's entry module (``pass`` around a whole-file call, ``request``
around a single-frame call).  Device activity is every
kernel, memcpy and memset the profiler saw on the card; the busy time is
the union of their intervals inside the window, so work on two streams at
once counts once.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

WINDOW = "window"


@dataclasses.dataclass
class Interval:
    name: str
    start: float  # seconds, profiler clock
    end: float
    kind: str  # "kernel", "memcpy", "memset" or "cpu"
    thread: int = 0


@dataclasses.dataclass
class Trace:
    """Device intervals and host spans of one traced window."""

    window: tuple[float, float]
    device: list[Interval]
    host: list[Interval]
    spans: tuple[str, ...] = (WINDOW,)  # the benchmark's own span names

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self, names: tuple[str, ...] | None = None) -> list[Interval]:
        """Kernels inside the window, all or those whose name contains one
        of ``names``."""
        w0, w1 = self.window
        return [d for d in self.device
                if d.kind == "kernel" and d.start >= w0 and d.end <= w1
                and (names is None or any(n in d.name for n in names))]

    def busy_s(self) -> float:
        """Seconds in the window in which some device operation ran."""
        return sum(b - a for a, b in busy_intervals(self.device,
                                                    self.window))

    def idle_gaps(self) -> list[tuple[float, float]]:
        w0, w1 = self.window
        gaps, t = [], w0
        for a, b in busy_intervals(self.device, self.window):
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < w1:
            gaps.append((t, w1))
        return gaps


def busy_intervals(device: list[Interval], window) -> list[tuple[float,
                                                                 float]]:
    """The union of the device intervals, clipped to ``window``, sorted."""
    w0, w1 = window
    spans = sorted((max(d.start, w0), min(d.end, w1)) for d in device
                   if d.end > w0 and d.start < w1)
    out: list[list[float]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _kind(name: str, activity: str | None) -> str:
    if activity:
        if "memcpy" in activity:
            return "memcpy"
        if "memset" in activity:
            return "memset"
        if activity in ("kernel", "concurrent_kernel"):
            return "kernel"
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def from_profiler(prof, spans: tuple[str, ...] = (WINDOW,)) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` to a :class:`Trace`;
    ``spans`` are the names of the benchmark's own spans."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() / 1e9
        end = start + e.duration_ns() / 1e9
        act = getattr(e, "activity_type", None)  # absent in older torch
        act = str(act()) if act else None
        if str(e.device_type()).endswith("CUDA"):
            if name in spans or (act and "annotation" in act):
                continue  # the device's copy of a host span
            device.append(Interval(name, start, end, _kind(name, act)))
        else:
            host.append(Interval(name, start, end, "cpu",
                                 e.start_thread_id()))
    windows = [h for h in host if h.name == WINDOW]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w = max(windows, key=lambda h: h.end - h.start)
    return Trace((w.start, w.end), device, host, tuple(spans))


def innermost(items: list[Interval], points: list[float]) -> list:
    """For each of the ascending ``points``, the innermost of the nested,
    start-sorted ``items`` open there (None where none is): a sweep with a
    stack of the open ones."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(items) and items[i].start <= t:
            while stack and stack[-1].end < items[i].start:
                stack.pop()
            stack.append(items[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name), and the
    idle time of the device summed by what the host was doing: the
    benchmark's innermost span open at the gap, then the innermost host
    operation open at its middle."""
    w0, w1 = tr.window
    by_op: dict[str, float] = defaultdict(float)
    for d in tr.device:
        if d.end > w0 and d.start < w1:
            by_op[d.name[:120]] += min(d.end, w1) - max(d.start, w0)
    main = [h for h in tr.host if h.name == WINDOW]
    thread = main[0].thread if main else None
    host = sorted((h for h in tr.host
                   if h.thread == thread and h.end > w0 and h.start < w1),
                  key=lambda h: h.start)
    gaps = tr.idle_gaps()
    mids = [(a + b) / 2 for a, b in gaps]
    spans = innermost([h for h in host if h.name in tr.spans], mids)
    ops = innermost([h for h in host if h.name not in tr.spans], mids)
    idle: dict[str, float] = defaultdict(float)
    for (a, b), span, op in zip(gaps, spans, ops):
        label = (span.name if span else "outside spans") + (
            f" / {op.name[:80]}" if op else " / python")
        idle[label] += b - a

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"device_ops": top_of(by_op), "idle_gaps": top_of(idle)}

"""Tracing and per-stage timing.

* :class:`StageTimers` — named wall-clock accumulators for pipeline stages
  (split/predict/entropy/serialize/transfer), reportable as a dict;
* :func:`trace` — context manager around ``torch.profiler.profile`` (the
  host, and the card when PyTorch sees one) that writes a Chrome trace
  (chrome://tracing, Perfetto) under ``log_dir`` or ``FPV_TPU_TRACE_DIR``;
* :func:`annotate` — a named range (``torch.profiler.record_function``, and
  an NVTX range once CUDA is initialized), so host stages show up beside
  the kernels in the trace.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch


class StageTimers:
    """Accumulating wall-clock timers keyed by stage name."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": round(v, 6), "calls": self.counts[k],
                "mean_ms": round(1000 * v / max(self.counts[k], 1), 3)}
            for k, v in sorted(self.totals.items())
        }

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed code with ``torch.profiler`` and write its
    Chrome trace to ``<log_dir>/fpvt_trace_<pid>_<ns>.json``; yields the
    profiler (``key_averages()``, ``events()``), or None when neither
    ``log_dir`` nor ``FPV_TPU_TRACE_DIR`` names a directory (no-op).  The
    card's activity is traced when PyTorch sees a CUDA device, and every
    thread's ranges where PyTorch can record them."""
    log_dir = log_dir or os.environ.get("FPV_TPU_TRACE_DIR")
    if not log_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts,
                                **_all_threads()) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"fpvt_trace_{os.getpid()}_{time.time_ns()}.json"))


def _all_threads() -> dict:
    """The profiler option recording every thread's ranges (the sharded
    paths work on pool threads), where this PyTorch has it."""
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return {}
    return {"experimental_config": cfg}


@contextlib.contextmanager
def annotate(name: str):
    """Named range visible in profiler traces (host timeline, and NVTX for
    CUDA tools once CUDA is initialized).  Exceptions raised inside the
    range propagate untouched."""
    nvtx = torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()

"""Tracing: one clock, the profiler's.

* :func:`trace` — context manager around ``torch.profiler.profile`` (the
  host, and the card when PyTorch sees one) that writes a Chrome trace
  (chrome://tracing, Perfetto) under ``log_dir`` or ``FPV_TPU_TRACE_DIR``;
* :func:`annotate` — a named host range (a profiler ``RecordFunction``
  while a profiler records, and an NVTX range once CUDA is initialized),
  so host stages show up beside the kernels they launch, on the same
  clock.  The codec's own ranges are named ``fpvt.<side>.<stage>``
  (``fpvt.read.parse``, ``fpvt.write.serialize``, ...; ``api/fpvt_codec.py``),
  the mesh's ``mesh.<phase>``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


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


def _profiling() -> bool:
    """A torch profiler is recording: one started through
    ``torch.profiler.profile`` (the Python flag, set for every thread,
    also with ``profile_all_threads``) or through the autograd C API."""
    return (torch.autograd.profiler._is_profiler_enabled
            or torch._C._autograd._profiler_enabled())


class annotate:
    """``with annotate(name):`` -- a named range visible in profiler traces
    (host timeline) while a profiler records, and to NVTX tools once CUDA
    is initialized; with neither it opens nothing, so the codec's ranges
    stay on its hot paths.  Exceptions raised inside the range propagate
    untouched.

    The profiler range is recorded as a host operation, not as a user
    annotation (``torch.profiler.record_function``): kineto copies a user
    annotation onto the card's timeline around the kernels it launched,
    and such a copy would read as device work in a trace of the card."""

    __slots__ = ("_name", "_range", "_nvtx")

    def __init__(self, name: str) -> None:
        self._name = name

    def __enter__(self) -> None:
        self._range = (torch._C._profiler._RecordFunctionFast(self._name)
                       if _profiling() else None)
        if self._range is not None:
            self._range.__enter__()
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self._name)

    def __exit__(self, *exc) -> None:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._range is not None:
            self._range.__exit__(*exc)

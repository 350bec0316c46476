"""One run of one cell: set-up, the measured window, the check.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json``, the configuration file that entry names, the traffic
mix ``fpvbench/traffic/<traffic>.json``, the entry module that mix names,
``fpvbench/entries/<entry>.py``, and one reader a per-layer metric,
``fpvbench/metrics/<metric>.py``.  A traffic mix is data: the entry point
of the codec the window drives, how many seed-made recordings take turns,
and the keys its entry module declares; this file is the one generator
that reads it, and refuses a key that nothing reads.

An entry module holds what one entry point of the program needs: ``KEYS``
(the traffic keys it reads, with their types), ``SPAN`` (the name of the
traced span around each call) and ``Entry(ctx)`` with ``setup()``,
``call(i)``, ``after(result)``, ``end_to_end(window_s, latencies)``,
``check()``, a dict ``counts`` of the work it asked for (what per-layer
metrics divide by) and, optionally, ``release()`` to free the program's
state before the check.  It reaches the program, ``fpv_tpu_torch``, only
through ``ctx.codec``: this file imports it inside :func:`run_cell`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import pathlib
import sys
import time
import traceback

import numpy as np
import torch

from fpvbench import frames as framegen, trace as tracing
from fpvbench.faults import Faults

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent
# the keys every traffic mix may have; its entry module adds its own
TRAFFIC_KEYS = {"entry": str, "about": str, "recordings": int}


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the cell, by name


def load_benchmark(path: pathlib.Path | None = None) -> dict:
    return json.loads((path or REPO / "BENCHMARK.json").read_text())


def find(items: list[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str) -> dict:
    entry = find(bench["configs"], name, "configuration")
    return json.loads((REPO / entry["file"]).read_text())


def _module(kind: str, name: str):
    """``fpvbench/<kind>/<name>.py``, loaded from its file by name."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module {path.relative_to(REPO)}")
    spec = importlib.util.spec_from_file_location(
        f"fpvbench_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_module(name: str):
    """The entry module ``entries/<name>.py``."""
    return _module("entries", name)


def load_traffic(name: str) -> dict:
    """The traffic mix ``traffic/<name>.json``, its keys checked against
    what the harness and its entry module read."""
    mix = json.loads((ROOT / "traffic" / f"{name}.json").read_text())
    keys = dict(TRAFFIC_KEYS, **entry_module(mix["entry"]).KEYS)
    for k, v in mix.items():
        if k not in keys:
            raise ValueError(f"traffic {name!r}: nothing reads key {k!r}")
        if not isinstance(v, keys[k]) or isinstance(v, bool):
            raise ValueError(f"traffic {name!r}: {k!r} must be "
                             f"{keys[k].__name__}, not {v!r}")
    missing = set(keys) - set(mix)
    if missing:
        raise ValueError(f"traffic {name!r} lacks {sorted(missing)}")
    return mix


def metrics_for(bench: dict, key: str, workload: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]


def metric_reader(name: str):
    """``read(reading) -> float | None`` of ``metrics/<name>.py``."""
    return _module("metrics", name).read


# ---------------------------------------------------------------------------
# what an entry module works with


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator) -> None:
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def mismatch(got, want: np.ndarray) -> int:
    """Samples of ``want`` that ``got`` does not reproduce (all of them
    when the shapes differ)."""
    if not isinstance(got, np.ndarray) or got.shape != want.shape:
        return int(want.size)
    return int(np.count_nonzero(got != want))


@dataclasses.dataclass
class Context:
    """One run's configuration, traffic mix and recordings, and the
    program under test: ``codec`` is the module ``fpv_tpu_torch``."""

    cfg: dict
    mix: dict
    codec: object
    faults: Faults
    recordings: list[np.ndarray]  # host uint16 camera samples
    rng: np.random.Generator
    trace: bool
    device: torch.device

    def encode(self, frames: np.ndarray) -> bytes:
        """An FPVT file of ``frames`` at the configuration's settings."""
        c = self.cfg
        return self.codec.encode_file_fpvt(
            frames, shift=c["shift"], big_endian=c["big_endian"],
            frames_per_batch=c["frames_per_batch"],
            chunk_log2=c["chunk_log2"], device=self.device)

    def expected(self, r: int) -> np.ndarray:
        """What a reader must return for recording ``r``: the samples
        left-aligned by the configuration's shift."""
        return (self.recordings[r] << np.uint16(self.cfg["shift"])).astype(
            np.uint16)


# ---------------------------------------------------------------------------
# one run


@dataclasses.dataclass
class Reading:
    """What a per-layer metric reads: the traced window and the entry's
    counts of the work it asked for in it."""

    trace: tracing.Trace
    counts: dict


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", fault: str | None = None, t0: float | None = None,
             bench: dict | None = None, cfg: dict | None = None) -> dict:
    """Run ``workload`` once -> the result line as a dict.  ``cfg``
    replaces the configuration's file (the tests' small frames)."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = bench or load_benchmark()
    cell = find(bench["workloads"], workload, "workload")
    cfg = cfg or load_config(bench, cell["config"])
    mix = load_traffic(cell["traffic"])
    dev = torch.device(device)
    # frames: one seed-derived recording per slot, made on the device
    seeds = framegen.recording_seeds(seed, mix["recordings"] + 1)
    recordings = []
    for s in seeds[: mix["recordings"]]:
        rec = framegen.plasma(cfg["frames_per_recording"], cfg["height"],
                              cfg["width"], cfg["bits"],
                              cfg["content"]["noise"], s, dev)
        recordings.append(framegen.to_host(rec))
        del rec
    import fpv_tpu_torch

    module = entry_module(mix["entry"])
    ctx = Context(cfg, mix, fpv_tpu_torch, Faults(fault, cfg["shift"]),
                  recordings, np.random.default_rng(seeds[-1]), trace, dev)
    entry = module.Entry(ctx)
    entry.setup()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()

    def span(name):
        return (torch.profiler.record_function(name) if trace
                else contextlib.nullcontext())

    latencies, attempted, failed = [], 0, 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    with span(tracing.WINDOW):
        while time.perf_counter() < deadline:
            c0 = time.perf_counter()
            try:
                with span(module.SPAN):
                    result = entry.call(attempted)
            except Exception:  # a failed call counts; the window goes on
                failed += 1
                if failed == 1:
                    log(traceback.format_exc())
                result = None
            latencies.append(time.perf_counter() - c0)
            if result is not None:
                entry.after(result)
            attempted += 1
    t_end = time.perf_counter()
    window_s = t_end - t_start
    if prof is not None:
        _sync(dev)
        prof.__exit__(None, None, None)

    peak = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else 0)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else dev.type),
                   "count": cell["chips"], "memory_peak_bytes": peak}
    metrics, extra = {}, {}
    if trace:
        tr = tracing.from_profiler(prof, (tracing.WINDOW, module.SPAN))
        del prof
        reading = Reading(tr, entry.counts)
        for m in metrics_for(bench, "per_layer", workload):
            v = metric_reader(m["name"])(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        extra["breakdown"] = tracing.breakdown(tr)
    elif attempted - failed > 0:
        e2e = entry.end_to_end(window_s, latencies)
        e2e["setup_s"] = t_start - t0
        for m in metrics_for(bench, "end_to_end", workload):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    # the check, once the program's state is freed
    if hasattr(entry, "release"):
        entry.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    checks = {"calls_failed": failed,
              "calls_missing": int(attempted - failed == 0)}
    checks.update(entry.check())
    log(f"check took {time.perf_counter() - c0} s; window {window_s} s, "
        f"{attempted} calls, setup {t_start - t0} s")
    checks = {k: {"value": int(v), "limit": 0} for k, v in checks.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info, **extra,
            "checks": checks}

"""Where the time goes in the FPVT main path on one CUDA card.

    python3 -m fpv_tpu_torch.utils.profile_codec [--frames 128] [--runs 3]

Runs ``encode_file_fpvt`` -> ``decode_file_fpvt`` on the chip smoke corpus
(``--frames`` x 1024 x 1024 12-bit plasma, shift 4, 32 frames per batch,
chunk_log2 12) and prints one JSON line per part:

1. ``runs``: steady-state encode and decode wall seconds (after one warm-up
   call of each), ``torch.cuda.synchronize()`` around each call.
2. ``trace``: one traced call of each under ``torch.profiler``.  The rows
   with device time (kernels and copies) sum to the device's busy time
   (the decode's downloads run on a second stream beside its kernels, so
   overlapping rows count twice); ``busy_share`` is that over the traced
   wall time.
3. ``phases``: one call of each with a synchronize around every phase
   (upload, model step, tables, plane coding, K1a/K1b/K2 wrappers,
   serialization, parse, staging uploads, K2 launch, inverse spatial,
   temporal, download).  The syncs add time and stop the decode's
   overlap, so this is a breakdown, not a rate.  Nested phases
   overlap: the K1a/K1b wrappers are inside plane coding, which is inside
   the batch encode.
4. ``trace`` of the decode hub (``MultiStreamDecoder``) on the encoded
   file fed in 1 MiB pieces: host frames at 1 and 2 streams, and the
   device-resident replay (device frames, a shared upload cache, a
   content_id) at 1 and 4 streams, each after one warm-up run.  Every
   trace also lists the host rows with the most self time.  Then
   ``threads``: one more run of each while a sampler records the Python
   line each of the hub's workers (issue, finalize) and the feeding
   thread is on, every 0.5 ms: where each thread spends its time.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from fpv_tpu_torch.api import fpvt_codec
from fpv_tpu_torch.api.multistream import MultiStreamDecoder
from fpv_tpu_torch.entropy import plane_codec
from fpv_tpu_torch.format import fpvt
from fpv_tpu_torch.ops import rans_cuda
from fpv_tpu_torch.utils import kernels, testdata

# (owner, attribute, phase name) of every phase timed in part 3
PHASES = (
    (fpvt_codec.FpvtWriter, "_put", "enc.upload"),
    (fpvt_codec.FpvtWriter, "init", "enc.delta_section"),
    (fpvt_codec, "encode_model_step", "enc.model_step"),
    (fpvt_codec, "_fused_plane_job", "enc.tables"),
    (fpvt_codec, "code_planes", "enc.planes (K1 + pull)"),
    (rans_cuda, "rans_encode_chain", "enc.K1a (wrapper)"),
    (rans_cuda, "rans_encode_place", "enc.K1b (wrapper + counts pull)"),
    (fpvt, "serialize_batch_section", "enc.serialize"),
    (fpvt, "parse_batch_section", "dec.parse"),
    (plane_codec, "stage_plane_ranges", "dec.stage (pinned uploads)"),
    (plane_codec, "launch_plane_ranges", "dec.planes (K2 launch)"),
    (rans_cuda, "rans_decode_grouped", "dec.K2 (wrapper)"),
    (fpvt_codec, "_inverse_spatial", "dec.inverse_spatial"),
    (fpvt_codec, "_apply_temporal", "dec.temporal"),
    (fpvt_codec, "_download", "dec.download (pinned)"),
)


def _wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def _timed_phases(acc: dict):
    """Wrap every PHASES function with a synchronized timer adding to
    ``acc``; the originals are put back on exit."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in PHASES]

    def wrap(fn, name):
        def timed(*args, **kw):
            out, dt = _wall(lambda: fn(*args, **kw))
            acc[name] += dt
            return out
        return timed

    try:
        for (owner, attr, fn), (_o, _a, name) in zip(saved, PHASES):
            setattr(owner, attr, wrap(fn, name))
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def _trace(fn) -> dict:
    """Traced wall time, device busy time and the largest device rows."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _out, wall = _wall(fn)

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0)

    rows = [e for e in prof.key_averages()
            if dev_us(e) > 0 and not e.key.startswith("aten::")]
    busy = sum(dev_us(e) for e in rows) / 1e6
    top = sorted(rows, key=lambda e: -dev_us(e))[:12]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return dict(wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
                top_ms_launches=[(e.key[:60], dev_us(e) / 1e3, e.count)
                                 for e in top],
                host_top_self_ms_calls=[
                    (e.key[:60], e.self_cpu_time_total / 1e3, e.count)
                    for e in host[:12]])


def _thread_samples(fn, period_s: float = 5e-4, top: int = 8) -> dict:
    """One run of ``fn`` while a sampler thread records, every
    ``period_s``, the innermost Python line of the decode hub's issue
    worker, its finalize worker and the calling thread -> wall s and, per
    thread, the lines seen most often with their share of that thread's
    samples (time in a C call counts at the Python line that made it)."""
    counts = collections.defaultdict(collections.Counter)
    caller = threading.get_ident()
    stop = threading.Event()

    def role(name):
        return ("issue" if "(_run)" in name else
                "finalize" if "(_run_fin)" in name else None)

    def sample():
        while not stop.wait(period_s):
            roles = {t.ident: role(t.name) for t in threading.enumerate()}
            roles[caller] = "caller"
            for ident, frame in sys._current_frames().items():
                if roles.get(ident):
                    code = frame.f_code
                    counts[roles[ident]][
                        f"{pathlib.Path(code.co_filename).name}:"
                        f"{frame.f_lineno}:{code.co_name}"] += 1

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        _out, wall = _wall(fn)
    finally:
        stop.set()
        sampler.join(timeout=10)
    out = dict(wall_s=wall, period_s=period_s)
    for name, c in counts.items():
        total = sum(c.values())
        out[name] = dict(samples=total, top=[(line, n / total)
                                             for line, n in c.most_common(top)])
    return out


def _hub(data: bytes, nstreams: int, **hub_kw) -> None:
    """The decode hub with ``nstreams`` streams each fed ``data`` in 1 MiB
    pieces, interleaved; the sink counts frames."""
    seen = [0]
    hub = MultiStreamDecoder(
        sink=lambda sid, fr, ts: seen.__setitem__(0, seen[0] + fr.shape[0]),
        devices=["cuda"], **hub_kw)
    cid = "corpus" if hub_kw.get("upload_cache") is not None else None
    for i in range(nstreams):
        hub.add_stream(f"s{i}", content_id=cid)
    for s in range(0, len(data), 1 << 20):
        for i in range(nstreams):
            hub.feed(f"s{i}", data[s : s + (1 << 20)])
    hub.close()
    # every batch plus frame 0, the delta section
    if seen[0] != nstreams * (1 + sum(n for _o, n in fpvt.parse_footer(data))):
        raise AssertionError("decode hub lost frames")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_codec: torch.cuda.is_available() is false")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    frames = testdata.plasma_frames(args.frames, 1024, 1024, bits=12)
    kw = dict(shift=4, frames_per_batch=32, chunk_log2=12, device="cuda")
    kernels.library()

    def enc():
        return fpvt_codec.encode_file_fpvt(frames, **kw)

    def dec():
        return fpvt_codec.decode_file_fpvt(data, device="cuda")

    data = enc()
    dec()
    enc_s, dec_s = [], []
    for _ in range(args.runs):
        enc_s.append(_wall(enc)[1])
        dec_s.append(_wall(dec)[1])
    print(json.dumps(dict(part="runs", mpix=frames.size / 1e6,
                          encode_s=enc_s, decode_s=dec_s)), flush=True)
    for name, fn in (("encode", enc), ("decode", dec)):
        print(json.dumps(dict(part="trace", phase=name, **_trace(fn))),
              flush=True)
    acc = collections.defaultdict(float)
    with _timed_phases(acc):
        got, acc["enc.total"] = _wall(enc)
        out, acc["dec.total"] = _wall(
            lambda: fpvt_codec.decode_file_fpvt(got, device="cuda"))
    if got != data or not np.array_equal(out, frames << 4):
        raise AssertionError("profiled round trip differs")
    print(json.dumps(dict(part="phases", **acc)), flush=True)
    # the decode hub: host frames, and the device-resident replay (device
    # frames, a shared upload cache staged by a first run, a content_id)
    cache: dict = {}
    for name, nstreams, hub_kw in (
        ("decode hub, 1 stream", 1, {}),
        ("decode hub, 2 streams", 2, {}),
        ("replay, 1 stream", 1, dict(device_frames=True, upload_cache=cache)),
        ("replay, 4 streams", 4, dict(device_frames=True, upload_cache=cache)),
    ):
        _hub(data, nstreams, **hub_kw)  # warm-up (stages the replay cache)
        print(json.dumps(dict(part="trace", phase=name, **_trace(
            lambda: _hub(data, nstreams, **hub_kw)))), flush=True)
        print(json.dumps(dict(part="threads", phase=name, **_thread_samples(
            lambda: _hub(data, nstreams, **hub_kw)))), flush=True)


if __name__ == "__main__":
    main()

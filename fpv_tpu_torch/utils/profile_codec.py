"""Where the time goes in the FPVT main path on one CUDA card.

    python3 -m fpv_tpu_torch.utils.profile_codec [--frames 128] [--runs 3]

Runs ``encode_file_fpvt`` -> ``decode_file_fpvt`` on the chip smoke corpus
(``--frames`` x 1024 x 1024 12-bit plasma, shift 4, 32 frames per batch,
chunk_log2 12) and prints one JSON line per part:

1. ``runs``: steady-state encode and decode wall seconds (after one warm-up
   call of each), ``torch.cuda.synchronize()`` around each call.
2. ``trace``: one traced call of each under ``torch.profiler``.  The rows
   with device time (kernels and copies; all on one stream) sum to the
   device's busy time; ``busy_share`` is that over the traced wall time.
3. ``phases``: one call of each with a synchronize around every phase
   (upload, model step, plane coding, K1/K2 wrappers, serialization,
   parse, inverse spatial, temporal, combine + download).  The syncs add
   time, so this is a breakdown, not a rate.  Nested phases overlap: the
   K1 wrapper is inside plane coding, which is inside the batch encode.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import subprocess
import time

import numpy as np
import torch

from fpv_tpu_torch.api import fpvt_codec
from fpv_tpu_torch.format import fpvt
from fpv_tpu_torch.ops import rans_cuda
from fpv_tpu_torch.utils import kernels, testdata

# (owner, attribute, phase name) of every phase timed in part 3
PHASES = (
    (fpvt_codec.FpvtWriter, "_put", "enc.upload"),
    (fpvt_codec.FpvtWriter, "init", "enc.delta_section"),
    (fpvt_codec, "encode_model_step", "enc.model_step"),
    (fpvt_codec, "_encode_plane_fused", "enc.plane (tables+K1+pull)"),
    (rans_cuda, "rans_encode", "enc.K1 (wrapper)"),
    (fpvt, "serialize_batch_section", "enc.serialize"),
    (fpvt, "parse_batch_section", "dec.parse"),
    (fpvt_codec, "decode_plane_batch", "dec.plane (upload+K2)"),
    (rans_cuda, "rans_decode", "dec.K2 (wrapper)"),
    (fpvt_codec, "_inverse_spatial", "dec.inverse_spatial"),
    (fpvt_codec, "_apply_temporal", "dec.temporal"),
    (fpvt_codec, "_to_u16", "dec.combine+download"),
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
    return dict(wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
                top_ms_launches=[(e.key[:60], dev_us(e) / 1e3, e.count)
                                 for e in top])


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


if __name__ == "__main__":
    main()

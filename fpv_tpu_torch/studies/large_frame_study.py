"""Large-frame (4096 x 4096) chunk-length A/B study, on the port.

The counterpart of the JAX package's ``examples/large_frame_study.py``:
does the chunk length change the codec's speed on 16 Mpix frames, and at
what cost in file size?

* chunk_log2 in {11, 12, 13} re-encodes the same frames (the header
  carries chunk_log2, so each variant is a valid file) through
  ``FpvtWriter(narrow=False)``, the fused 1024-lane geometry at every
  chunk length.
* Device-resident encode: ``fused_encode_batch`` on frames already on the
  device (its tables, states, counts and payloads come to the host, as
  the writer needs them).  Device-resident decode: ``batch_decode_args``'
  arrays uploaded once, then ``fused_decode_batch`` (the reader's decode
  path: one K2 launch, the inverse predictions, the temporal add, frames
  left on the device), with previews and without, so the preview pass is
  priced separately.  Each decode is checked exact before it is timed.
* Times: CUDA events around each call, best of ``--reps``, the decodes
  round-robin across the chunk lengths.  On the CPU (``--device cpu``)
  the host clock, and the numbers are the CPU's.

Geometry (B = 4, 4096^2, per plane): chunk 2^11 -> 32 blocks of 1024
lanes, 2^12 -> 16, 2^13 -> 8.  ``--fast`` runs 2 frames of 256^2.

    python -m fpv_tpu_torch.studies.large_frame_study [--fast] [--reps N]
        [--chunks 11,12,13] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from fpv_tpu_torch.api.fpvt_codec import (
    FpvtReader,
    FpvtWriter,
    batch_decode_args,
    fused_decode_batch,
    fused_encode_batch,
    put_frames,
    resolve_device,
)
from fpv_tpu_torch.utils import testdata
from fpv_tpu_torch.utils.platform import argv_device

SHIFT = 4
# batch_decode_args' arrays in fused_decode_batch's argument order (the
# delta planes go in after "fcs")
DECODE_ARGS = ("payload", "plane_offs", "counts", "states", "flags",
               "sym_tabs", "fcs", "const_vals")


def _timed(fn, stream) -> float:
    """Seconds of one ``fn()``: CUDA events on ``stream`` around it (the
    call must end with its device work done), or the host clock without a
    stream (the CPU)."""
    if stream is None:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    fn()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def run(size: int, frames: int, chunks: list[int], reps: int,
        device="cuda") -> dict:
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    h = w = size
    b = frames
    base = testdata.plasma_frames(1, h, w, bits=12, seed=11)[0]
    all_frames = np.stack(
        [np.roll(base, (3 * i, 5 * i), (0, 1)) for i in range(b + 1)]
    )
    want = torch.from_numpy(
        (all_frames[1:].astype(np.uint16) << SHIFT).astype(np.int32)
    ).to(dev)

    res: dict = {"b": b, "h": h, "w": w, "chunk_log2s": chunks}
    variants = []  # (chunk_log2, decode(previews))
    for cl in chunks:
        wr = FpvtWriter(w, h, shift=SHIFT, frames_per_batch=b,
                        chunk_log2=cl, narrow=False, device=dev)
        data = wr.init(all_frames[0])
        data += wr.encode_batch(all_frames[1:])
        data += wr.finish()
        res[f"cl{cl}_file_bytes"] = len(data)
        res[f"cl{cl}_bpp"] = 8.0 * len(data) / (b * h * w * 2)

        imgs_dev = put_frames(all_frames[1:], dev)
        stream = torch.cuda.current_stream(dev) if cuda else None

        def _enc(_w=wr, _k=1 << cl, _im=imgs_dev):
            return fused_encode_batch(
                _im, _w._delta_high, _w._delta_low, SHIFT, False, _k,
                low_coding=_w._low_coding, allow_prev=True,
            )

        _enc()
        ts = [_timed(_enc, stream) for _ in range(reps)]
        res[f"cl{cl}_enc_mpix_s"] = b * h * w / 1e6 / min(ts)
        del imgs_dev

        rdr = FpvtReader(data, device=dev)
        arrays, static = batch_decode_args(
            rdr._parse_batch(rdr._batches[0][0]), 1 << cl)
        args = [torch.from_numpy(arrays[n]).to(dev) for n in DECODE_ARGS]
        args[7:7] = [wr._delta_high, wr._delta_low]

        def _dec(pv, _args=args, _k=1 << cl, _static=static):
            return fused_decode_batch(*_args, chunk_len=_k, b=b, h=h, w=w,
                                      decode_preview=pv, **_static)

        for pv in (True, False):
            imgs, ok = _dec(pv)[:2]
            if not bool(ok):
                raise AssertionError(f"chunk_log2={cl} integrity failed")
            if not torch.equal(imgs, want):
                raise AssertionError(f"chunk_log2={cl} decode mismatch")
            del imgs
        variants.append((cl, _dec, stream))

    # round-robin decode timing: previews on and off as separate passes
    for label, pv in (("dec", True), ("dec_nopv", False)):
        best = {cl: float("inf") for cl, _f, _s in variants}
        for _ in range(reps):
            for cl, fn, stream in variants:
                best[cl] = min(best[cl], _timed(lambda: fn(pv), stream))
        for cl, t in best.items():
            res[f"cl{cl}_{label}_mpix_s"] = b * h * w / 1e6 / t
    return res


def main(argv: list[str] | None = None) -> None:
    argv, device = argv_device(argv, "large_frame_study")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="256^2 x 2 frames smoke")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--chunks", type=str, default="11,12,13")
    args = ap.parse_args(argv)
    size, frames = (256, 2) if args.fast else (4096, 4)
    chunks = [int(c) for c in args.chunks.split(",")]
    rep = run(size, frames, chunks, reps=args.reps, device=device)
    print(json.dumps(rep, indent=2))


if __name__ == "__main__":
    main()

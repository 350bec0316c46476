#!/usr/bin/env python3
"""Chip smoke run of fpv_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Checks for a CUDA device and prints the card's name and power limit.
2. Builds the CUDA kernels from ``fpv_tpu_torch/csrc`` (nvcc, first use).
3. Holds each kernel (K1 rANS encode, K2 rANS decode, K3 CG2D inverse)
   against its plain PyTorch version on the card at the main path's shapes,
   exactly, and times both (CUDA events, median).
4. Drives the main path: ``encode_file_fpvt`` -> FPVT bytes ->
   ``decode_file_fpvt`` on the bench corpus (128 x 1024 x 1024 12-bit
   plasma frames, shift 4, 32 frames per batch) on the card, checks the
   round trip is lossless and that every kernel was launched by it, and
   checks that a small file's bytes are the same on the card and on the
   CPU (where the plain versions run; the CPU tests hold those bytes to
   the JAX package's).
5. Prints a JSON line of the kernels, then the result line
   ``{"ok": true, "device": {...}}`` last.

Any failure raises (non-zero exit) and prints no result line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from fpv_tpu_torch.api.fpvt_codec import (
    decode_file_fpvt,
    encode_file_fpvt,
    encode_model_step,
    pv_chunk_len,
)
from fpv_tpu_torch.entropy.plane_codec import (
    _hist_flat,
    _to_block_symbols,
    ctx_indices_device,
    ctx_presence_device,
    lens_tensor,
)
from fpv_tpu_torch.entropy.tables_device import (
    encode_tables_ctx_device,
    encode_tables_device,
    normalize_freqs_ctx_device,
    normalize_freqs_device,
)
from fpv_tpu_torch.format import fpvt
from fpv_tpu_torch.format.fpvt import F_SPATIAL_SHIFT
from fpv_tpu_torch.ops import predict, rans_cuda
from fpv_tpu_torch.ops.planes import split_planes
from fpv_tpu_torch.ops.rans_layout import CTX_PROB_BITS
from fpv_tpu_torch.utils import kernels, testdata

N_FRAMES, H, W, BITS, SHIFT, FPB, CHUNK_LOG2 = 128, 1024, 1024, 12, 4, 32, 12
TALL = (1, 65536, 64)  # the format's tallest frame, one CTA's wavefront


def cuda_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` on the card in ms (CUDA events)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, ref) -> int:
    """Largest absolute difference between two tuples of int tensors; a
    shape mismatch fails."""
    err = 0
    for g, r in zip(got, ref):
        if g.shape != r.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(r.shape)}")
        d = (g.to(torch.int64) - r.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def rans_cases(frames: np.ndarray, dev):
    """K1 inputs at the main path's shapes, from the first batch's model
    step: (name, syms, lens, fc, chunk_len, prob_bits, ctx)."""
    imgs = torch.from_numpy(frames[1 : 1 + FPB].view(np.int16)).to(dev)
    imgs = imgs.to(torch.int32) & 0xFFFF
    dh, dl, _nz = split_planes(
        torch.from_numpy(frames[:1].view(np.int16)).to(dev), SHIFT, False
    )
    m = encode_model_step(imgs, dh[0], dl[0], SHIFT, False, True, True, True)
    k = 1 << CHUNK_LOG2
    cases = []
    for name, plane, k_p in (
        ("high", m["high"], k),
        ("preview", m["preview"], pv_chunk_len(k)),
    ):
        plane = plane.reshape(FPB, -1)
        lens = lens_tensor(FPB, plane.shape[1], k_p, dev)
        freq = normalize_freqs_device(m[f"hist_{name}"], m[f"mask_{name}"])
        cases.append((f"order0 {name} k={k_p}",
                      _to_block_symbols(plane, k_p, lens.shape[0]), lens,
                      encode_tables_device(freq), k_p, 12, False,
                      rans_cuda.fused_table_arrays(freq.cpu().numpy())))
    low = m["low"].reshape(FPB, -1)
    for k_p in (k, 512):
        lens = lens_tensor(FPB, low.shape[1], k_p, dev)
        sym4 = _to_block_symbols(low >> 4, k_p, lens.shape[0])
        hist = _hist_flat(ctx_indices_device(sym4), 512)
        freq = normalize_freqs_ctx_device(hist, ctx_presence_device(sym4))
        cases.append((f"ctx16 low k={k_p}", sym4, lens,
                      encode_tables_ctx_device(freq), k_p, CTX_PROB_BITS,
                      True,
                      rans_cuda.ctx_fused_table_arrays(freq.cpu().numpy())))
    return m, cases


def check_rans(frames, dev, results):
    """K1 and K2 against their plain versions; returns the model step."""
    m, cases = rans_cases(frames, dev)
    for name, syms, lens, fc, k, pb, ctx, table in cases:
        def enc():
            return rans_cuda.rans_encode(syms, lens, fc, pb, ctx)

        def enc_ref():
            return rans_cuda.rans_encode_ref(syms, lens, fc, pb, ctx)

        got, ref = enc(), enc_ref()
        err = max_err(got, ref)
        states, counts, payload = got
        starts = torch.cumsum(counts.to(torch.int64), 0) - counts
        dec_args = (counts, starts, states, lens,
                    rans_cuda.u32_tensor(table, dev), payload)

        def dec():
            return rans_cuda.rans_decode(*dec_args, k, pb, ctx)

        def dec_ref():
            return rans_cuda.rans_decode_ref(*dec_args, k, pb, ctx)

        d_got, d_ref = dec(), dec_ref()
        d_err = max_err(d_got, d_ref)
        if not bool((d_got[1] == 1).all()):
            raise AssertionError(f"K2 ok flags not all set on {name}")
        if not torch.equal(d_got[0], syms):
            raise AssertionError(f"K2 did not invert K1 on {name}")
        bad = payload.clone()
        bad[bad.numel() // 2] ^= 0x0100
        b_args = dec_args[:5] + (bad,)
        b_got = rans_cuda.rans_decode(*b_args, k, pb, ctx)
        b_ref = rans_cuda.rans_decode_ref(*b_args, k, pb, ctx)
        d_err = max(d_err, max_err(b_got, b_ref))
        if bool((b_got[1] == 1).all()):
            raise AssertionError(f"K2 missed a flipped word on {name}")
        if err or d_err:
            raise AssertionError(f"kernel != plain on {name}: {err} {d_err}")
        row = dict(case=name, blocks=int(syms.shape[0]), chunk_len=k,
                   enc_ms=cuda_ms(enc, 5), enc_plain_ms=cuda_ms(enc_ref, 2),
                   dec_ms=cuda_ms(dec, 5), dec_plain_ms=cuda_ms(dec_ref, 2),
                   max_abs_err=max(err, d_err))
        print("rans", json.dumps(row), flush=True)
        results.append(row)
    return m


def check_cg2d(high: torch.Tensor, dev, results):
    """K3 against its plain version on a batch of real frames and on a
    tall frame."""
    rng = np.random.default_rng(0)
    tall = torch.from_numpy(
        rng.integers(0, 256, TALL, np.int64).astype(np.uint8)
    ).to(dev)
    for name, plane, plain_reps in (
        (str(list(high[:16].shape)), high[:16].contiguous(), 2),
        (str(list(TALL)), tall, 0),
    ):
        res = predict.cg2d_encode(plane)

        def run():
            return predict.cg2d_decode(res)

        def run_ref():
            return predict.cg2d_decode_ref(res)

        got = run()
        t0 = time.perf_counter()
        ref = run_ref()
        torch.cuda.synchronize()
        plain_once = (time.perf_counter() - t0) * 1e3
        err = max_err((got,), (ref,))
        if err or not torch.equal(got, plane):
            raise AssertionError(f"K3 wrong on {name}: {err}")
        row = dict(case=name, ms=cuda_ms(run, 5),
                   plain_ms=cuda_ms(run_ref, plain_reps) if plain_reps
                   else plain_once, max_abs_err=err)
        print("cg2d", json.dumps(row), flush=True)
        results.append(row)


def main() -> None:
    # The run uses one card: only the first visible one is made visible,
    # before CUDA starts, so the device count reported is the card used.
    card_id = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = card_id
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    if torch.cuda.device_count() != 1:
        raise SystemExit("chip_smoke: CUDA sees more than the one card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", f"--id={card_id}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    t0 = time.perf_counter()
    kernels.library()
    print(f"kernel build+load: {time.perf_counter() - t0:.3f} s", flush=True)

    t0 = time.perf_counter()
    frames = testdata.plasma_frames(N_FRAMES, H, W, bits=BITS)
    print(f"corpus {frames.shape} {frames.dtype}: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    rans_rows, cg_rows = [], []
    m = check_rans(frames, dev, rans_rows)
    check_cg2d(m["high"], dev, cg_rows)
    del m
    torch.cuda.empty_cache()

    # the main path, counted
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = encode_file_fpvt(frames, shift=SHIFT, frames_per_batch=FPB,
                            chunk_log2=CHUNK_LOG2, device=dev)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = decode_file_fpvt(data, device=dev)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if out.shape != frames.shape or not np.array_equal(out, frames << SHIFT):
        raise AssertionError("main path round trip is not lossless")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    mpix = frames.size / 1e6
    modes = np.zeros(3, np.int64)  # batch frames per spatial predictor
    for off, _n in fpvt.parse_footer(data):
        flags = fpvt.parse_batch_section(data, off).frame_flags
        modes += np.bincount((flags >> F_SPATIAL_SHIFT) & 3, minlength=3)[:3]
    print(json.dumps(dict(
        card=card, frames=list(frames.shape), bits=BITS, shift=SHIFT,
        frames_per_batch=FPB, chunk_log2=CHUNK_LOG2, bytes=len(data),
        bits_per_pixel=len(data) * 8 / frames.size,
        encode_s=t_enc, decode_s=t_dec, encode_mpix_s=mpix / t_enc,
        decode_mpix_s=mpix / t_dec, launches=launches,
        spatial_none_up_cg2d=modes.tolist(),
        lossless=True)), flush=True)

    # a small file: same bytes on the card and on the CPU plain versions
    small = testdata.plasma_frames(9, 64, 128, bits=BITS, seed=5)
    kw = dict(shift=SHIFT, frames_per_batch=4, chunk_log2=8)
    on_card = encode_file_fpvt(small, device=dev, **kw)
    if on_card != encode_file_fpvt(small, device="cpu", **kw):
        raise AssertionError("card and CPU wrote different bytes")
    if not np.array_equal(decode_file_fpvt(on_card, device=dev),
                          small << SHIFT):
        raise AssertionError("small file round trip is not lossless")
    print("small file: card bytes == CPU bytes, lossless", flush=True)

    main_rans = rans_rows[0]
    kernels_line = {"kernels": [
        dict(name="rans_encode", route="cuda",
             source="fpv_tpu_torch/csrc/rans_encode.cu",
             replaces="fpv_tpu/ops/rans_pallas.py:880",
             launches=launches["rans_encode"],
             max_abs_err=max(r["max_abs_err"] for r in rans_rows),
             ms=main_rans["enc_ms"], plain_ms=main_rans["enc_plain_ms"],
             shape=main_rans["case"]),
        dict(name="rans_decode", route="cuda",
             source="fpv_tpu_torch/csrc/rans_decode.cu",
             replaces="fpv_tpu/ops/rans_pallas.py:999",
             launches=launches["rans_decode"],
             max_abs_err=max(r["max_abs_err"] for r in rans_rows),
             ms=main_rans["dec_ms"], plain_ms=main_rans["dec_plain_ms"],
             shape=main_rans["case"]),
        dict(name="cg2d_decode", route="cuda",
             source="fpv_tpu_torch/csrc/cg2d_decode.cu",
             replaces="fpv_tpu/ops/predict.py:231",
             launches=launches["cg2d_decode"],
             max_abs_err=max(r["max_abs_err"] for r in cg_rows),
             ms=cg_rows[0]["ms"], plain_ms=cg_rows[0]["plain_ms"],
             shape=cg_rows[0]["case"]),
    ]}
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()

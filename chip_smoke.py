#!/usr/bin/env python3
"""Chip smoke run of fpv_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Checks for a CUDA device and prints the card's name and power limit.
2. Builds the CUDA kernels from ``fpv_tpu_torch/csrc`` (nvcc, first use).
3. Holds each kernel (K1 rANS encode, K2 rANS decode, K3 CG2D inverse)
   against its plain PyTorch version on the card at the main path's shapes,
   exactly, and times both (CUDA events, median); K1/K2 also at the narrow
   lane counts the small-file paths use (8 lanes x 1024 steps, the golden
   fixtures' batch planes; 128 lanes x 32768 steps, the narrow maximum).
4. Drives the main path: ``encode_file_fpvt`` -> FPVT bytes ->
   ``decode_file_fpvt`` on the bench corpus (128 x 1024 x 1024 12-bit
   plasma frames, shift 4, 32 frames per batch) on the card, checks the
   round trip is lossless and that every kernel was launched by it, and
   checks that a small (narrow-stream) file's bytes are the same on the
   card and on the CPU (where the plain versions run; the CPU tests hold
   those bytes to the JAX package's).
5. Decodes the golden fixtures (tests/golden) on the card pixel-exact and
   re-encodes their inputs to the pinned SHA-256s.
6. Round-trips a 5 x 1024 x 1024 file, whose 4 Mi-symbol body is the
   largest written with narrow streams (128 lanes).
7. On the main corpus file: random access (``decode_frame``) against the
   full decode, every batch's previews against previews of the decoded
   frames (K3 runs on CG2D previews), and the streaming reader fed in
   1 MiB pieces.
8. Prints a JSON line of the kernels, then the result line
   ``{"ok": true, "device": {...}}`` last.

Each path (4, 5, 6, 7) is driven with the launch counts set to 0 just
before it and read just after; a kernel the path needs that it did not
launch fails the run.  Any failure raises (non-zero exit) and prints no
result line.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import statistics
import subprocess
import time

import numpy as np
import torch

from fpv_tpu_torch.api.fpvt_codec import (
    FpvtReader,
    FpvtStreamingReader,
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
    narrow_geometry,
    plane_blocks,
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
from fpv_tpu_torch.ops.preview import generate_preview
from fpv_tpu_torch.ops.rans_layout import CTX_PROB_BITS
from fpv_tpu_torch.utils import kernels, testdata

N_FRAMES, H, W, BITS, SHIFT, FPB, CHUNK_LOG2 = 128, 1024, 1024, 12, 4, 32, 12
TALL = (1, 65536, 64)  # the format's tallest frame, one CTA's wavefront
NARROW_FRAMES = 5  # 1 delta frame + a 4 Mi-symbol body: 128-lane streams
GOLDEN = pathlib.Path(__file__).resolve().parent / "tests" / "golden"


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


def narrow_cases(dev):
    """K1 inputs of narrow streams, from the model step of a file's first
    batch: the golden drift fixture's (4 frames of 32 x 48: 8 lanes, 1024
    steps) and the narrow maximum's (4 frames of 1024^2: 128 lanes, 32768
    steps), order-0 high plane and ctx16 low plane of each."""
    with np.load(GOLDEN / "inputs.npz") as z:
        drift = z["drift"]
    cases = []
    for frames in (drift[:5], testdata.plasma_frames(5, H, W, bits=BITS)):
        t = torch.from_numpy(frames.view(np.int16)).to(dev)
        t = t.to(torch.int32) & 0xFFFF
        dh, dl, _nz = split_planes(t[:1], SHIFT, False)
        m = encode_model_step(t[1:], dh[0], dl[0], SHIFT, False, True, True,
                              True)
        n = m["high"].numel()
        lanes, k = narrow_geometry(n)
        for coding, name in ((0, "high"), (1, "low")):
            plane = m[name].reshape(4, -1)
            hist = m["hist_high"].cpu().numpy() if coding == 0 else None
            mask = m["mask_high"].cpu().numpy() if coding == 0 else None
            syms, lens, fc, freq = plane_blocks(plane, k, lanes, coding,
                                                hist, mask)
            table = (rans_cuda.ctx_fused_table_arrays(freq) if coding
                     else rans_cuda.fused_table_arrays(freq))
            cases.append((f"{'ctx16 low' if coding else 'order0 high'} "
                          f"lanes={lanes} k={k}", syms, lens, fc, k,
                          CTX_PROB_BITS if coding else 12, bool(coding),
                          table))
    return cases


def check_rans(cases, dev, results, plain_reps=2):
    """K1 and K2 against their plain versions on each case; exact equality,
    K2 inverting K1, and K2's ok flags catching a flipped payload word.
    ``plain_reps`` 0 runs each plain version once and records that one
    run's wall time (synchronized) as its time."""
    for name, syms, lens, fc, k, pb, ctx, table in cases:
        def enc():
            return rans_cuda.rans_encode(syms, lens, fc, pb, ctx)

        def enc_ref():
            return rans_cuda.rans_encode_ref(syms, lens, fc, pb, ctx)

        got = enc()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = enc_ref()
        torch.cuda.synchronize()
        enc_plain_once = (time.perf_counter() - t0) * 1e3
        err = max_err(got, ref)
        states, counts, payload = got
        starts = torch.cumsum(counts.to(torch.int64), 0) - counts
        dec_args = (counts, starts, states, lens,
                    rans_cuda.u32_tensor(table, dev), payload)

        def dec():
            return rans_cuda.rans_decode(*dec_args, k, pb, ctx)

        def dec_ref():
            return rans_cuda.rans_decode_ref(*dec_args, k, pb, ctx)

        d_got = dec()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_ref = dec_ref()
        torch.cuda.synchronize()
        dec_plain_once = (time.perf_counter() - t0) * 1e3
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
        row = dict(
            case=name, blocks=int(syms.shape[0]), lanes=int(syms.shape[2]),
            chunk_len=k, enc_ms=cuda_ms(enc, 5),
            enc_plain_ms=(cuda_ms(enc_ref, plain_reps) if plain_reps
                          else enc_plain_once),
            dec_ms=cuda_ms(dec, 5),
            dec_plain_ms=(cuda_ms(dec_ref, plain_reps) if plain_reps
                          else dec_plain_once),
            plain_timing="median of 2" if plain_reps else "one run",
            max_abs_err=max(err, d_err))
        print("rans", json.dumps(row), flush=True)
        results.append(row)


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


def counted(path: str, need: tuple, fn):
    """Run ``fn`` with the launch counts set to 0 just before and read just
    after; fail if a kernel in ``need`` was not launched."""
    kernels.reset_launches()
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in need if launches[k] == 0]
    if missing:
        raise AssertionError(f"{path} never launched {missing}")
    print(f"{path} launches", json.dumps(launches), flush=True)
    return out, launches


def check_golden(dev) -> None:
    """The golden fixtures decode pixel-exact on the card, and their inputs
    re-encode to the pinned SHA-256s."""
    with np.load(GOLDEN / "inputs.npz") as z:
        inputs = {k: z[k] for k in z.files}
    with open(GOLDEN / "hashes.json") as f:
        pins = json.load(f)
    for name, key, shift in (("v4.fpvt", "drift", 4), ("v5.fpvt", "drift", 4),
                             ("v6_drift.fpvt", "drift", 4),
                             ("v6_raw.fpvt", "noise16", 0)):
        got = decode_file_fpvt((GOLDEN / name).read_bytes(), device=dev)
        if not np.array_equal(got, inputs[key] << shift):
            raise AssertionError(f"golden {name} did not decode exactly")
    for name, key, shift in (("v6_drift.fpvt", "drift", 4),
                             ("v6_raw.fpvt", "noise16", 0)):
        data = encode_file_fpvt(inputs[key], shift=shift, frames_per_batch=4,
                                chunk_log2=8, device=dev)
        if hashlib.sha256(data).hexdigest() != pins[name]:
            raise AssertionError(f"golden {name}: the card's bytes differ")
    print("golden fixtures: 4 decoded exactly, 2 re-encoded to their pins",
          flush=True)


def check_narrow_max(dev) -> dict:
    """The largest narrow-stream file: 5 x 1024^2, a 4 Mi-symbol body."""
    frames = testdata.plasma_frames(NARROW_FRAMES, H, W, bits=BITS)
    t0 = time.perf_counter()
    data = encode_file_fpvt(frames, shift=SHIFT, frames_per_batch=FPB,
                            chunk_log2=CHUNK_LOG2, device=dev)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = decode_file_fpvt(data, device=dev)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    if not np.array_equal(out, frames << SHIFT):
        raise AssertionError("narrow-maximum round trip is not lossless")
    off, _n = fpvt.parse_footer(data)[0]
    pb = fpvt.parse_batch_section(data, off)
    lanes = [st.lanes for st in (pb.high, pb.low, pb.preview)]
    if lanes[0] != narrow_geometry(frames[1:].size)[0]:
        raise AssertionError(f"narrow-maximum streams have lanes {lanes}")
    row = dict(frames=list(frames.shape), bytes=len(data),
               lanes_high_low_preview=lanes, encode_s=t_enc, decode_s=t_dec,
               lossless=True)
    print("narrow max", json.dumps(row), flush=True)
    return row


def check_reader(data: bytes, out: np.ndarray, dev) -> dict:
    """Random access, previews and streaming on the main corpus file."""
    r = FpvtReader(data, device=dev)
    row = {}
    # frame 0 (the delta frame), a batch's first frame, a mid-chain frame
    # (index 7 of a batch) and the last frame
    for i in (0, 1 + FPB, 1 + FPB + 7, N_FRAMES - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = r.decode_frame(i)
        torch.cuda.synchronize()
        row[f"decode_frame_{i}_s"] = time.perf_counter() - t0
        if not np.array_equal(got, out[i]):
            raise AssertionError(f"decode_frame({i}) != full decode")
    t0 = time.perf_counter()
    r.decode_batch(1)
    torch.cuda.synchronize()
    row["decode_batch_s"] = time.perf_counter() - t0
    return row


def check_previews(data: bytes, out: np.ndarray, dev) -> dict:
    """Every batch's previews against previews of the decoded frames; the
    time is that of the decode_previews calls alone (synchronized)."""
    r = FpvtReader(data, device=dev)
    spent = []
    for bi, (_off, b) in enumerate(r._batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = r.decode_previews(bi)
        spent.append(time.perf_counter() - t0)
        s = 1 + bi * FPB
        high = torch.from_numpy((out[s : s + b] >> 8).astype(np.uint8))
        want = generate_preview(high.to(dev)).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"batch {bi} previews are wrong")
    return dict(decode_previews_s=spent, batches=r.num_batches)


def check_streaming(data: bytes, out: np.ndarray, dev) -> None:
    got = []
    sr = FpvtStreamingReader(lambda imgs, ts: got.append(imgs), device=dev)
    for s in range(0, len(data), 1 << 20):
        sr.decode(data[s : s + (1 << 20)])
    if not np.array_equal(np.concatenate(got), out):
        raise AssertionError("streaming reader frames differ")
    print("streaming reader (1 MiB pieces): frames equal", flush=True)


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
    m, cases = rans_cases(frames, dev)
    check_rans(cases, dev, rans_rows)
    check_cg2d(m["high"], dev, cg_rows)
    del m, cases
    narrow = narrow_cases(dev)
    check_rans(narrow[:2], dev, rans_rows)
    check_rans(narrow[2:], dev, rans_rows, plain_reps=0)
    del narrow
    torch.cuda.empty_cache()

    # the main path, counted
    def round_trip():
        t0 = time.perf_counter()
        data = encode_file_fpvt(frames, shift=SHIFT, frames_per_batch=FPB,
                                chunk_log2=CHUNK_LOG2, device=dev)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = decode_file_fpvt(data, device=dev)
        torch.cuda.synchronize()
        return data, out, t_enc, time.perf_counter() - t0

    (data, out, t_enc, t_dec), launches = counted(
        "main path", tuple(kernels.LAUNCHES), round_trip
    )
    if out.shape != frames.shape or not np.array_equal(out, frames << SHIFT):
        raise AssertionError("main path round trip is not lossless")
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

    counted("golden", ("rans_encode", "rans_decode"),
            lambda: check_golden(dev))
    counted("narrow max", ("rans_encode", "rans_decode"),
            lambda: check_narrow_max(dev))
    row, _ = counted("random access", ("rans_decode",),
                     lambda: check_reader(data, out, dev))
    print("random access", json.dumps(row), flush=True)
    row, pv_launches = counted("previews", ("rans_decode", "cg2d_decode"),
                               lambda: check_previews(data, out, dev))
    print("previews", json.dumps(row), flush=True)
    counted("streaming", ("rans_decode",),
            lambda: check_streaming(data, out, dev))
    del out

    main_rans = rans_rows[0]

    def rans_cases_line(prefix):
        return [dict(case=r["case"], lanes=r["lanes"], k=r["chunk_len"],
                     ms=r[f"{prefix}_ms"], plain_ms=r[f"{prefix}_plain_ms"],
                     plain_timing=r["plain_timing"],
                     max_abs_err=r["max_abs_err"]) for r in rans_rows]

    kernels_line = {"kernels": [
        dict(name="rans_encode", route="cuda",
             source="fpv_tpu_torch/csrc/rans_encode.cu",
             replaces="fpv_tpu/ops/rans_pallas.py:880",
             launches=launches["rans_encode"],
             max_abs_err=max(r["max_abs_err"] for r in rans_rows),
             ms=main_rans["enc_ms"], plain_ms=main_rans["enc_plain_ms"],
             shape=main_rans["case"], cases=rans_cases_line("enc")),
        dict(name="rans_decode", route="cuda",
             source="fpv_tpu_torch/csrc/rans_decode.cu",
             replaces="fpv_tpu/ops/rans_pallas.py:999",
             launches=launches["rans_decode"],
             max_abs_err=max(r["max_abs_err"] for r in rans_rows),
             ms=main_rans["dec_ms"], plain_ms=main_rans["dec_plain_ms"],
             shape=main_rans["case"], cases=rans_cases_line("dec")),
        dict(name="cg2d_decode", route="cuda",
             source="fpv_tpu_torch/csrc/cg2d_decode.cu",
             replaces="fpv_tpu/ops/predict.py:231",
             launches=launches["cg2d_decode"],
             preview_launches=pv_launches["cg2d_decode"],
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

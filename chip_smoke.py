#!/usr/bin/env python3
"""Chip smoke run of fpv_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Checks for a CUDA device and prints the card's name and power limit.
2. Builds the CUDA kernels from ``fpv_tpu_torch/csrc`` (nvcc, first use).
3. Holds each kernel (K1a rANS state chain, K1b rANS placement, K2 rANS
   decode, K3 CG2D inverse) against its plain PyTorch version on the card
   at the main path's shapes, exactly, and times both (CUDA events,
   median): per plane, and as the main path launches them, one batch's
   planes in one grouped launch, with the bound (the function's bytes at
   3.35 TB/s; K1's split between its two passes) and the share of it
   reached; K3 at each shape the main path launches it (one frame, a
   batch of frames, a batch of previews) and on the tallest frame, with
   ns per anti-diagonal.  K1/K2 also at the narrow lane counts the
   small-file paths use (8 lanes x 1024 steps, the golden fixtures' batch
   planes; 128 lanes x 32768 steps, the narrow maximum).
4. Drives the main path: ``encode_file_fpvt`` -> FPVT bytes ->
   ``decode_file_fpvt`` on the bench corpus (128 x 1024 x 1024 12-bit
   plasma frames, shift 4, 32 frames per batch) on the card, checks the
   round trip is lossless, that every kernel was launched by it, and that
   K1a/K1b ran once per batch and K2 once per batch and delta section;
   and checks that a small (narrow-stream) file's bytes are the same on
   the card and on the CPU (where the plain versions run; the CPU tests
   hold those bytes to the JAX package's).
5. Decodes the golden fixtures (tests/golden) on the card pixel-exact and
   re-encodes their inputs to the pinned SHA-256s.
6. Round-trips a 5 x 1024 x 1024 file, whose 4 Mi-symbol body is the
   largest written with narrow streams (128 lanes).
7. On the main corpus file: random access (``decode_frame``) against the
   full decode, every batch's previews against previews of the decoded
   frames (K3 runs on CG2D previews), and the streaming reader fed in
   1 MiB pieces.
8. The serving hubs (``api/multistream.py``): the encode hub on two
   camera streams (corpus frames 0-63 and 64-127, pushed interleaved),
   each stream lossless and byte-equal to a single-threaded
   ``FpvtWriter(narrow=False)``; the decode hub on the corpus file, 1
   stream with previews and 2 streams, host frames, exact; the
   device-resident replay (device frames, a shared upload cache, a
   content_id) at 1, 2 and 4 streams, adding no cache entries after the
   first; one ``hubs`` JSON line of their Mpix/s beside
   ``decode_file_fpvt``'s on the same file, with the card's name and power
   limit.  Launches per hub path are checked against the files' sections.
9. Malformed input on the card: mutations and truncations of a small
   1024-lane file that reach K2 and K3 decode or raise ValueError, then a
   clean decode of the corpus file's batch 1 equals the full decode.
10. The multi-device layer (``parallel/mesh.py``, ``parallel/distributed.py``)
   on the corpus file: ``sharded_encode_file`` over ``make_mesh()`` (D = 1,
   the card) equals ``encode_file_fpvt``'s bytes and ``sharded_decode_file``
   its frames and the reader's previews, with the single-device file's
   launches (K1a/K1b 6/6, K2 5, K3 1); over two logical shards of the card
   (frames_per_batch 16) the same against ``encode_file_fpvt`` at 16; wall
   seconds of each beside the single-device calls (a warm-up and three
   runs); ``sharded_codec_roundtrip`` on 2 shards of 16 1024^2 frames at
   chunk 4096 (ok, exact, one K1a/K1b/K2 per shard); ``multichip_dryrun(2)``;
   ``warmup_stream(mesh=)``; two gloo ranks on the card as subprocesses
   (``--rank-worker``; 81 frames, the single-process file's SHA-256 on
   both, exact decodes); a fresh process's cold start to one
   ``warmup_stream`` with the library built (no nvcc); one
   ``profiling.trace`` of a D = 1 encode + decode (busy share, the three
   longest kernels, the ``mesh.*`` spans).  One ``mesh`` JSON line.
11. The FPV1 compatibility profile (``encode_file``/``decode_file``,
   ``Encoder``, the decoders): the device filter chain on the card
   against the CPU's on 8 corpus crops; K4 (flat CG inverse) against its
   plain version on the residuals the main path gives it (the delta
   frame's and the CG frames' of the first 64 corpus frames, one run of
   the plain version), and on 4 x 256 x 256; then, counted, the main
   path: ``encode_file`` + ``decode_file`` of those 64 frames (shift 4,
   8 brotli threads), lossless, three runs each, with one K4 launch per
   decode batch plus one for a CG delta frame; card bytes equal CPU bytes
   on a small file; ``tests/golden/v1_drift.fpv`` pixel-exact and its
   inputs re-encoded to the pin; random access, previews and the
   streaming decoder (1 MiB pieces); the time split (brotli threads, the
   device step, K4).  One ``fpv1`` JSON line.  Without the system
   libbrotli the phase checks the filter chain and K4 only and says so.
12. Transcoding and the tools, on the FPV1 phase's 64-frame file:
   ``transcode_to_fpvt`` (shift 4) and ``transcode_to_fpv1`` of its
   output, a warm-up and three timed calls each, counted (K4 once per
   FPVT batch plus the delta frame's, K1a/K1b per batch and coded delta
   plane; K2 per batch plus the delta section's, K3 where a section
   picked CG2D); FPV1 -> FPVT -> FPV1 returns the input file and the FPVT
   decodes to the frames; card bytes equal CPU bytes on 9 x 64 x 128;
   the decode/encode time split of each direction; the five tools as
   parallel subprocesses with ``--device cuda`` (encode both profiles of
   9 raw corpus frames against the in-process encode, decode, transcode
   both ways, ``inspect --check``, ``benchmark`` both profiles,
   ``--device cpu`` against ``cuda`` bytes);
   ``ColumnarBatchEncoder``/``Decoder`` on 32 corpus frames (FULL, MSB8,
   PREVIEW exact, one K4 launch per batch, card arrays equal CPU arrays
   on a crop); the Arrow round trip when pyarrow is installed (which
   happened is printed).  One ``transcode`` JSON line.
13. The measurement tools (``ops/rans_bound.py``, ``studies/``): every
   K2 variant (``csrc/rans_decode_variants.cu``: the stub_tables and
   stub_window latency replicas, per-class tables, precisions 11 and 10,
   two-table lookups, nsub 2/4/8 blocks per CTA) against its plain
   version bit for bit, on 3 blocks and at the reports' shape (64 blocks
   of 512 steps), the decoding variants also against the stream; K1a's
   nsub variant against K1a and its plain version; then, counted, the
   five reports at the JAX module's defaults and ``large_frame_study`` at
   full size (4 frames of 4096^2, chunk_log2 11-13); the three entropy
   studies at ``--fast`` on the card, equal to the CPU's numbers; the
   ptxas registers and spills of every kernel.  One ``bound`` JSON line.
14. Prints a JSON line of the kernels, then the result line
   ``{"ok": true, "device": {...}}`` last.

Each path (4-13) is driven with the launch counts set to 0 just
before it and read just after; a kernel the path needs that it did not
launch fails the run.  Any failure raises (non-zero exit) and prints no
result line.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import re
import statistics
import struct
import importlib.util
import socket
import subprocess
import sys
import tempfile
import time

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fpv_tpu_torch.api import decoder as fpv1_decoder
from fpv_tpu_torch.api import encoder as fpv1_encoder
from fpv_tpu_torch.api import frame as frame_ops
from fpv_tpu_torch.api.decoder import (
    RandomAccessDecoder,
    StreamingDecoder,
    decode_file,
)
from fpv_tpu_torch.api.encoder import encode_file
from fpv_tpu_torch.api.fpvt_codec import (
    FpvtReader,
    FpvtStreamingReader,
    FpvtWriter,
    decode_file_fpvt,
    encode_file_fpvt,
    encode_model_step,
    pv_chunk_len,
    warmup_stream,
)
from fpv_tpu_torch.api.multistream import MultiStreamDecoder, MultiStreamEncoder
from fpv_tpu_torch.api.transcode import transcode_to_fpv1, transcode_to_fpvt
from fpv_tpu_torch.batch.columnar import (
    ColumnarBatchDecoder,
    ColumnarBatchEncoder,
    ImageType,
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
from fpv_tpu_torch.entropy import brotli
from fpv_tpu_torch.format import container, fpvt
from fpv_tpu_torch.models import predictors
from fpv_tpu_torch.format.fpvt import (
    F_PV_SPATIAL_SHIFT,
    F_SPATIAL_SHIFT,
    SPATIAL_CG2D,
)
from fpv_tpu_torch.ops import predict, rans_bound, rans_cuda
from fpv_tpu_torch.ops.planes import split_planes
from fpv_tpu_torch.ops.preview import generate_preview
from fpv_tpu_torch.ops.rans_layout import (
    CODING_CTX16,
    CODING_ORDER0,
    CODING_RAW,
    CTX_PROB_BITS,
)
from fpv_tpu_torch.parallel.distributed import (
    distributed_decode_file,
    distributed_encode_file,
    global_data_mesh,
    initialize,
)
from fpv_tpu_torch.parallel.mesh import (
    make_mesh,
    multichip_dryrun,
    sharded_codec_roundtrip,
    sharded_decode_file,
    sharded_encode_file,
)
from fpv_tpu_torch.studies import (
    class_tables_study,
    ctx_study,
    large_frame_study,
    temporal_study,
)
from fpv_tpu_torch.utils import kernels, profiling, testdata

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


HBM_BYTES_PER_MS = 3.35e9  # H100 SXM: 3.35 TB/s


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def timed_once(fn):
    """(result, synchronized wall ms) of one call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def check_rans(cases, dev, results, plain_reps=2):
    """Per plane: K1a, K1b and K2 against their plain versions, exactly;
    K2 inverting K1; K2's ok flags catching a flipped payload word and
    agreeing with the plain version on a corrupted count.  Times the
    single-plane calls (K1 = K1a + K1b, comparable with the one-pass K1
    before the split) and each pass.  ``plain_reps`` 0 runs each plain version once and records that
    one run's wall time (synchronized).  Returns the plain results, which
    the grouped check reuses."""
    refs = []
    for name, syms, lens, fc, k, pb, ctx, table in cases:
        plane = rans_cuda.EncodePlane(syms, lens, fc, pb, ctx)
        chain = rans_cuda.rans_encode_chain([plane])[0]
        chain_ref, chain_plain_once = timed_once(
            lambda: rans_cuda.rans_encode_chain_ref(*plane))
        err = max_err(chain, chain_ref)
        place = rans_cuda.rans_encode_place([chain[1:]])[0]
        place_ref, place_plain_once = timed_once(
            lambda: rans_cuda.rans_place_ref(*chain_ref[1:3]))
        err = max(err, max_err((place,), (place_ref,)))
        states, counts, payload = rans_cuda.rans_encode_grouped([plane])[0]
        enc_ref = (chain_ref[0], chain_ref[3], place_ref)
        err = max(err, max_err((states, counts, payload), enc_ref))
        starts = torch.cumsum(counts.to(torch.int64), 0) - counts
        # the payload laid out as the reader uploads it (aligned, padded)
        staged = rans_cuda.staged_payload(payload)
        dec_plane = rans_cuda.DecodePlane(
            counts, starts, states, lens, rans_cuda.u32_tensor(table, dev),
            staged, k, pb, ctx)
        d_got = rans_cuda.rans_decode_grouped([dec_plane])[0]
        d_ref, dec_plain_once = timed_once(
            lambda: rans_cuda.rans_decode_ref(*dec_plane))
        d_err = max_err(d_got, d_ref)
        if not bool((d_got[1] == 1).all()):
            raise AssertionError(f"K2 ok flags not all set on {name}")
        if not torch.equal(d_got[0], syms):
            raise AssertionError(f"K2 did not invert K1 on {name}")
        bad = rans_cuda.staged_payload(staged.clone())
        bad[bad.numel() // 2] ^= 0x0100
        bad_count = counts.clone()
        bad_count[bad_count.numel() // 2] += 1
        for corrupt, must_fail in ((dec_plane._replace(payload=bad), True),
                                   (dec_plane._replace(counts=bad_count),
                                    False)):
            b_got = rans_cuda.rans_decode_grouped([corrupt])[0]
            b_ref = rans_cuda.rans_decode_ref(*corrupt)
            d_err = max(d_err, max_err(b_got, b_ref))
            if must_fail and bool((b_got[1] == 1).all()):
                raise AssertionError(f"K2 missed a flipped word on {name}")
        if err or d_err:
            raise AssertionError(f"kernel != plain on {name}: {err} {d_err}")

        def plain(fn, once):
            return cuda_ms(fn, plain_reps) if plain_reps else once

        row = dict(
            case=name, blocks=int(syms.shape[0]), lanes=int(syms.shape[2]),
            chunk_len=k,
            enc_ms=cuda_ms(lambda: rans_cuda.rans_encode_grouped([plane]), 5),
            chain_ms=cuda_ms(lambda: rans_cuda.rans_encode_chain([plane]), 5),
            place_ms=cuda_ms(
                lambda: rans_cuda.rans_encode_place([chain[1:]]), 5),
            chain_plain_ms=plain(
                lambda: rans_cuda.rans_encode_chain_ref(*plane),
                chain_plain_once),
            place_plain_ms=plain(
                lambda: rans_cuda.rans_place_ref(*chain_ref[1:3]),
                place_plain_once),
            dec_ms=cuda_ms(lambda: rans_cuda.rans_decode_grouped([dec_plane]),
                           5),
            dec_plain_ms=plain(lambda: rans_cuda.rans_decode_ref(*dec_plane),
                               dec_plain_once),
            plain_timing="median of 2" if plain_reps else "one run",
            max_abs_err=max(err, d_err))
        print("rans", json.dumps(row), flush=True)
        results.append(row)
        refs.append(dict(chain=chain_ref, place=place_ref, dec=dec_plane,
                         dec_ref=d_ref, row=row))
    return refs


def check_rans_grouped(cases, refs, enc_idx, dec_idx) -> dict:
    """The main path's grouped launches on one batch: K1a and K1b on the
    planes ``enc_idx`` of ``cases`` together (high, ctx16 low, preview),
    K2 on ``dec_idx`` together (high and low), against the per-plane plain
    results of :func:`check_rans`; CUDA-event times, the plain versions'
    summed per-plane times, and the bounds.  A bound is the bytes the
    function must move (every input read once, every output written once)
    at 3.35 TB/s; integer work has no peak rate in the card's table, so
    bytes bound.  K1 is one function (symbols, lens and tables in; states,
    counts and payload out) whose two passes split its bytes: K1a's share
    is the inputs, states and counts it reads and writes, K1b's the
    payload it writes.  The words and ballots that K1a hands K1b are the
    split's own traffic, not the function's: their bytes are reported
    beside the bound (``*_traffic_bytes``), not in it."""
    planes = [rans_cuda.EncodePlane(*(cases[i][j] for j in (1, 2, 3, 5, 6)))
              for i in enc_idx]
    chains = rans_cuda.rans_encode_chain(planes)
    places = rans_cuda.rans_encode_place([c[1:] for c in chains])
    err = max(max(max_err(c, refs[i]["chain"]),
                  max_err((p,), (refs[i]["place"],)))
              for c, p, i in zip(chains, places, enc_idx))
    dec = [refs[i]["dec"] for i in dec_idx]
    decoded = rans_cuda.rans_decode_grouped(dec)
    d_err = max(max_err(g, refs[i]["dec_ref"])
                for g, i in zip(decoded, dec_idx))
    if err or d_err:
        raise AssertionError(f"grouped kernels != plain: {err} {d_err}")
    starts = [torch.cumsum(c[3].to(torch.int64), 0) for c in chains]
    chain_bytes = sum(nbytes(p.syms, p.lens, p.fc, c[0], c[3])
                      for p, c in zip(planes, chains))
    place_bytes = sum(nbytes(pl) for pl in places)
    chain_traffic = sum(nbytes(p.syms, p.lens, p.fc, *c)
                        for p, c in zip(planes, chains))
    place_traffic = sum(nbytes(c[1], c[2], st, pl)
                        for c, st, pl in zip(chains, starts, places))
    dec_bytes = sum(nbytes(p.counts, p.starts, p.states, p.lens, p.table,
                           p.payload, *o) for p, o in zip(dec, decoded))

    def plain_sum(key, idx):
        return sum(refs[i]["row"][key] for i in idx)

    row = dict(
        planes=[cases[i][0] for i in enc_idx],
        decoded_planes=[cases[i][0] for i in dec_idx],
        chain_ms=cuda_ms(lambda: rans_cuda.rans_encode_chain(planes), 10),
        place_ms=cuda_ms(
            lambda: rans_cuda.rans_encode_place([c[1:] for c in chains]), 10),
        dec_ms=cuda_ms(lambda: rans_cuda.rans_decode_grouped(dec), 10),
        chain_plain_ms=plain_sum("chain_plain_ms", enc_idx),
        place_plain_ms=plain_sum("place_plain_ms", enc_idx),
        dec_plain_ms=plain_sum("dec_plain_ms", dec_idx),
        chain_bytes=chain_bytes, place_bytes=place_bytes,
        k1_bytes=chain_bytes + place_bytes, dec_bytes=dec_bytes,
        chain_traffic_bytes=chain_traffic, place_traffic_bytes=place_traffic,
        max_abs_err=max(err, d_err))
    row["k1_ms"] = row["chain_ms"] + row["place_ms"]
    for p in ("chain", "place", "k1", "dec"):
        row[f"{p}_bound_ms"] = row[f"{p}_bytes"] / HBM_BYTES_PER_MS
        row[f"{p}_bound_share"] = row[f"{p}_bound_ms"] / row[f"{p}_ms"]
    print("rans grouped batch", json.dumps(row), flush=True)
    return row


def check_cg2d(high: torch.Tensor, preview: torch.Tensor, dev, results):
    """K3 against its plain version at the shapes the main path launches:
    one real frame (the delta section's launch), a batch of real frames (a
    batch whose frames pick CG2D), a batch of previews (the preview
    decode's launch), and a tall frame (64 row groups); its bound is 1
    byte in and 1 byte out per pixel at 3.35 TB/s, its chain H + W - 1
    dependent steps (``ns_per_diagonal``)."""
    rng = np.random.default_rng(0)
    tall = torch.from_numpy(
        rng.integers(0, 256, TALL, np.int64).astype(np.uint8)
    ).to(dev)
    for name, plane, plain_reps in (
        (str(list(high[:1].shape)), high[:1].contiguous(), 2),
        (str(list(high.shape)), high.contiguous(), 2),
        (str(list(preview.shape)), preview.contiguous(), 2),
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
                   else plain_once,
                   bound_ms=2 * plane.numel() / HBM_BYTES_PER_MS,
                   max_abs_err=err)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["ns_per_diagonal"] = row["ms"] * 1e6 / (sum(plane.shape[1:]) - 1)
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
    # (index 7 of a batch) and the last frame; each frame of a chain is one
    # K2 launch for its high and low planes together
    for i in (0, 1 + FPB, 1 + FPB + 7, N_FRAMES - 1):
        before = kernels.LAUNCHES["rans_decode"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = r.decode_frame(i)
        torch.cuda.synchronize()
        row[f"decode_frame_{i}_s"] = time.perf_counter() - t0
        row[f"decode_frame_{i}_k2_launches"] = (
            kernels.LAUNCHES["rans_decode"] - before)
        if not np.array_equal(got, out[i]):
            raise AssertionError(f"decode_frame({i}) != full decode")
    if row[f"decode_frame_{1 + FPB}_k2_launches"] != 1:
        raise AssertionError("an anchor frame's planes took more than one "
                             "K2 launch")
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


def expected_launches(data: bytes, previews: bool = False) -> dict:
    """The launches a file's encode and whole-file decode take as the main
    path groups its planes: K1a and K1b once per batch (high, low and
    preview together) plus once per coded delta-section plane (the delta
    section codes its planes one by one); K2 once per batch (high and low,
    and with ``previews`` the preview, together) plus once for the delta
    section; K3 once for the delta section and once per batch whose frames
    (or, with ``previews``, previews) pick CG2D."""
    def with_coding(codings, *streams):
        return [s for s in streams if s is not None and s.coding in codings]

    # K1 codes every plane that is not constant (a raw plane is chosen after
    # coding); K2 decodes the rANS-coded ones
    k1, k2 = ((CODING_ORDER0, CODING_CTX16, CODING_RAW),
              (CODING_ORDER0, CODING_CTX16))
    dflags, dh, dl = fpvt.parse_delta_section(data, fpvt.HEADER_SIZE)
    batches = [fpvt.parse_batch_section(data, off)
               for off, _n in fpvt.parse_footer(data)]

    def cg2d(flags, shift):
        return bool((((flags >> shift) & 3) == SPATIAL_CG2D).any())

    return dict(
        batches=len(batches),
        k1=(sum(bool(with_coding(k1, b.high, b.low, b.preview))
                for b in batches) + len(with_coding(k1, dh, dl))),
        k2=(sum(bool(with_coding(k2, b.high, b.low,
                                 b.preview if previews else None))
                for b in batches) + bool(with_coding(k2, dh, dl))),
        k3=(cg2d(np.array([dflags]), F_SPATIAL_SHIFT)
            + sum(cg2d(b.frame_flags, F_SPATIAL_SHIFT)
                  + (previews and cg2d(b.frame_flags, F_PV_SPATIAL_SHIFT))
                  for b in batches)),
    )


def check_grouped_launches(data: bytes, enc: dict, dec: dict) -> None:
    """The main path groups its planes (:func:`expected_launches`)."""
    want = expected_launches(data)
    got = (enc["rans_encode_chain"], enc["rans_encode_place"],
           dec["rans_decode"])
    if got != (want["k1"], want["k1"], want["k2"]):
        raise AssertionError(f"grouped launches {got}, want {want}")
    print("main path grouped launches", json.dumps(dict(
        batches=want["batches"], encode=enc, decode=dec)), flush=True)


HUB_HALF = N_FRAMES // 2  # frames per camera stream in the encode hub
REPLAY_STREAMS = (1, 2, 4)


def hub_encode(frames: np.ndarray, dev) -> tuple[dict, float]:
    """The encode hub on two camera streams, corpus frames 0-63 and
    64-127, pushed interleaved with timestamps 0..63 -> (stream -> file
    bytes, wall s)."""
    halves = {"cam0": frames[:HUB_HALF], "cam1": frames[HUB_HALF:]}
    out = {sid: [] for sid in halves}

    def run():
        hub = MultiStreamEncoder(
            W, H, shift=SHIFT, frames_per_batch=FPB, chunk_log2=CHUNK_LOG2,
            sink=lambda sid, d: out[sid].append(d), devices=[dev])
        for sid, fr in halves.items():
            hub.add_stream(sid, fr[0])
        for i in range(HUB_HALF):
            for sid, fr in halves.items():
                hub.push_frame(sid, i, fr[i])
        hub.close()

    _none, wall_ms = timed_once(run)
    return {sid: b"".join(parts) for sid, parts in out.items()}, wall_ms / 1e3


def writer_encode(frames: np.ndarray, dev) -> bytes:
    """One stream through a single-threaded ``FpvtWriter(narrow=False)``,
    as the encode hub writes it."""
    w = FpvtWriter(W, H, SHIFT, False, FPB, CHUNK_LOG2, device=dev,
                   narrow=False)
    parts = [w.init(frames[0])]
    for s in range(0, len(frames), FPB):
        parts.append(w.encode_batch(frames[s : s + FPB],
                                    np.arange(s, min(s + FPB, len(frames)))))
    return b"".join(parts + [w.finish()])


def check_encode_hub(frames: np.ndarray, dev) -> dict:
    """Each hub stream decodes losslessly, its bytes equal a single-threaded
    writer's on the same frames, and K1a/K1b ran as the files say."""
    (files, wall), launches = counted(
        "encode hub", ("rans_encode_chain", "rans_encode_place"),
        lambda: hub_encode(frames, dev))
    want_k1 = 0
    writer_s = 0.0
    for i, (sid, data) in enumerate(files.items()):
        half = frames[i * HUB_HALF : (i + 1) * HUB_HALF]
        if not np.array_equal(decode_file_fpvt(data, device=dev),
                              half << SHIFT):
            raise AssertionError(f"encode hub stream {sid} is not lossless")
        single, dt_ms = timed_once(lambda: writer_encode(half, dev))
        writer_s += dt_ms / 1e3
        if single != data:
            raise AssertionError(f"encode hub stream {sid} != FpvtWriter")
        want_k1 += expected_launches(data)["k1"]
    got = (launches["rans_encode_chain"], launches["rans_encode_place"])
    if got != (want_k1, want_k1):
        raise AssertionError(f"encode hub K1 launches {got}, want {want_k1}")
    mpix = frames.size / 1e6
    return dict(encode_hub_2_streams_s=wall,
                encode_hub_2_streams_mpix_s=mpix / wall,
                writer_sequential_s=writer_s,
                writer_sequential_mpix_s=mpix / writer_s,
                encode_hub_bytes=[len(d) for d in files.values()])


def hub_decode(data: bytes, nstreams: int, dev, keep: str,
               content_id=None, **hub_kw) -> tuple[dict, float]:
    """The decode hub with ``nstreams`` streams each fed ``data`` in 1 MiB
    pieces, interleaved -> (stream -> what the sink got, wall s).  The sink
    keeps every call (``keep="all"``) or, for device frames, the frame
    count and the second call (the first batch after frame 0)."""
    got = {f"s{i}": [] for i in range(nstreams)}
    frames_seen = dict.fromkeys(got, 0)

    def sink(sid, fr, ts, pv=None):
        frames_seen[sid] += fr.shape[0]
        if keep == "all" or len(got[sid]) < 2:
            got[sid].append((fr, ts, pv))

    def run():
        hub = MultiStreamDecoder(sink=sink, devices=[dev], **hub_kw)
        for sid in got:
            hub.add_stream(sid, content_id=content_id)
        for s in range(0, len(data), 1 << 20):
            for sid in got:
                hub.feed(sid, data[s : s + (1 << 20)])
        hub.close()

    _none, wall_ms = timed_once(run)
    if set(frames_seen.values()) != {N_FRAMES}:
        raise AssertionError(f"decode hub frames per stream {frames_seen}")
    return got, wall_ms / 1e3


def check_decode_hub(data: bytes, out: np.ndarray, dev) -> dict:
    """The decode hub, host frames: 1 stream with previews, then 2 streams;
    frames, timestamps and previews exact; K2 once per batch plus once per
    delta section, per stream; K3 as the flags say (CG2D previews)."""
    row = {}
    ts_want = np.concatenate(
        [np.full(1, -1, np.int64)]
        + [fpvt.parse_batch_section(data, off).timestamps
           for off, _n in fpvt.parse_footer(data)])
    pv_want = torch.cat([generate_preview(torch.from_numpy(
        (out[s : s + FPB] >> 8).astype(np.uint8)).to(dev))
        for s in range(0, N_FRAMES, FPB)]).cpu().numpy()
    for nstreams, previews in ((1, True), (2, False)):
        need = ("rans_decode", "cg2d_decode")
        (got, wall), launches = counted(
            f"decode hub {nstreams} host", need,
            lambda: hub_decode(data, nstreams, dev, "all",
                               want_previews=previews))
        for sid, calls in got.items():
            if not np.array_equal(np.concatenate([c[0] for c in calls]), out):
                raise AssertionError(f"decode hub stream {sid} frames differ")
            if not np.array_equal(np.concatenate([c[1] for c in calls]),
                                  ts_want):
                raise AssertionError(f"decode hub stream {sid} timestamps")
            if previews and not np.array_equal(
                    np.concatenate([c[2] for c in calls]), pv_want):
                raise AssertionError(f"decode hub stream {sid} previews")
        del got
        want = expected_launches(data, previews)
        got_k = (launches["rans_decode"], launches["cg2d_decode"])
        if got_k != (nstreams * want["k2"], nstreams * want["k3"]):
            raise AssertionError(f"decode hub launches {got_k}, want "
                                 f"{nstreams} x {want}")
        key = f"decode_hub_{nstreams}_host" + ("_previews" if previews
                                               else "")
        row[key + "_s"] = wall
        row[key + "_mpix_s"] = nstreams * out.size / 1e6 / wall
        row[key + "_launches"] = launches
    return row


def check_replay(data: bytes, out: np.ndarray, dev) -> dict:
    """The device-resident replay (bench.py's): device frames, one shared
    upload cache, a content_id; a first 1-stream run stages the batches,
    then 1, 2 and 4 streams run once each and add no cache entries.  The
    sink gets CUDA tensors equal to the host decode (the first batch of
    every stream)."""
    cache: dict = {}
    row = {}
    nbatches = len(fpvt.parse_footer(data))
    for i, nstreams in enumerate((1, *REPLAY_STREAMS)):
        (got, wall), launches = counted(
            f"replay {nstreams}" + (" (staging)" if i == 0 else ""),
            ("rans_decode",),
            lambda: hub_decode(data, nstreams, dev, "first", "corpus",
                               device_frames=True, upload_cache=cache))
        if len(cache) != nbatches:
            raise AssertionError(f"upload cache holds {len(cache)} entries,"
                                 f" want {nbatches}")
        for sid, calls in got.items():
            fr = calls[1][0]
            if fr.device.type != dev.type or fr.dtype != torch.int32:
                raise AssertionError(f"replay {sid}: {fr.device} {fr.dtype}")
            if not np.array_equal(fr.cpu().numpy().astype(np.uint16),
                                  out[1 : 1 + FPB]):
                raise AssertionError(f"replay stream {sid} batch 0 differs")
        if i:
            row[f"replay_{nstreams}_s"] = wall
            row[f"replay_{nstreams}_mpix_s"] = nstreams * out.size / 1e6 / wall
            row[f"replay_{nstreams}_launches"] = launches
        del got
    cache.clear()
    torch.cuda.empty_cache()
    return row


def check_fuzz(data: bytes, out: np.ndarray, dev) -> dict:
    """Single-byte mutations and truncations of a small wide file (some
    forcing CG2D frames, so K3 runs on garbage residuals, and one a high
    plane's count, so K2's check fails) decode or raise ValueError on the
    card; then batch 1 of the main corpus file decodes equal to the full
    decode, so the CUDA context survived."""
    frames = testdata.plasma_frames(5, 128, 160, bits=BITS, seed=8)
    wri = FpvtWriter(160, 128, SHIFT, False, 2, 4, device=dev,
                     delta_is_frame0=True, narrow=False)
    small = b"".join([wri.init(frames[0])]
                     + [wri.encode_batch(frames[s : s + 2]) for s in (1, 3)]
                     + [wri.finish()])
    mutants = []
    for off, n in fpvt.parse_footer(small):
        for j in range(n):  # frame flags: spatial bits -> CG2D
            m = bytearray(small)
            m[off + 17 + j] = (m[off + 17 + j] & ~6) | (SPATIAL_CG2D << 1)
            mutants.append(bytes(m))
        pos = off + 17 + 9 * n  # the high plane stream
        (nch,) = struct.unpack_from("<I", small, pos + 12)
        m = bytearray(small)
        struct.pack_into("<I", m, pos + 24 + 512 + 4 * nch, 5)
        mutants.append(bytes(m))
    rng = np.random.default_rng(11)
    for _ in range(60):
        m = bytearray(small)
        m[int(rng.integers(0, len(m)))] ^= int(rng.integers(1, 256))
        mutants.append(bytes(m))
    mutants += [small[: int(c)] for c in rng.integers(0, len(small), 15)]
    outcome = {"decoded": 0, "ValueError": 0}

    def run():
        for m in mutants:
            try:
                decode_file_fpvt(m, device=dev)
                r = FpvtReader(m, device=dev)
                for bi in range(r.num_batches):
                    r.decode_batch_with_previews(bi)
                outcome["decoded"] += 1
            except ValueError:
                outcome["ValueError"] += 1

    _none, launches = counted("fuzz", ("rans_decode", "cg2d_decode"), run)
    if not np.array_equal(FpvtReader(data, device=dev).decode_batch(1),
                          out[1 + FPB : 1 + 2 * FPB]):
        raise AssertionError("batch 1 after the fuzz != full decode")
    return dict(mutants=len(mutants), **outcome, launches=launches,
                clean_decode_after="equal")


MESH_FPB = 16  # frames per batch of the logical-shard and two-rank runs
RANKS = 2
RANK_FRAMES = 1 + RANKS * 2 * MESH_FPB + MESH_FPB  # 2 groups + a tail
ROUNDTRIP_FRAMES = 32
WORKER_TIMEOUT = 300


def launches_of(want: dict, encode: bool) -> dict:
    """:func:`expected_launches`' counts as :func:`check_launches` takes
    them, for an encode or a whole-file decode."""
    if encode:
        return {"rans_encode_chain": want["k1"],
                "rans_encode_place": want["k1"]}
    return {"rans_decode": want["k2"], "cg2d_decode": want["k3"]}


def reader_previews(data: bytes, dev) -> np.ndarray:
    """Every frame's preview as the reader gives it (frame 0's from the
    delta frame)."""
    r = FpvtReader(data, device=dev)
    return np.concatenate(
        [r.preview_frame(0)[None]]
        + [r.decode_batch_with_previews(i)[1] for i in range(r.num_batches)])


def rank_worker(rank: int, port: int, path: str) -> None:
    """One rank of the two-rank run: join the gloo group, encode the frames
    at ``path`` over the mesh of both ranks' cards (both cuda:0 here) and
    decode the file round-robin; print one ``RANK`` JSON line."""
    frames = np.load(path)
    initialize(f"127.0.0.1:{port}", RANKS, rank)
    mesh = global_data_mesh()
    kernels.reset_launches()
    data, enc_ms = timed_once(lambda: distributed_encode_file(
        frames, mesh=mesh, shift=SHIFT, frames_per_batch=MESH_FPB,
        chunk_log2=CHUNK_LOG2))
    enc = dict(kernels.LAUNCHES)
    out, dec_ms = timed_once(lambda: distributed_decode_file(data,
                                                             device="cuda"))
    if not np.array_equal(out, frames << SHIFT):
        raise AssertionError(f"rank {rank}: the decode is not pixel-exact")
    dec = {k: v - enc[k] for k, v in kernels.LAUNCHES.items()}
    torch.distributed.destroy_process_group()
    print("RANK " + json.dumps(dict(
        rank=rank, sha256=hashlib.sha256(data).hexdigest(),
        encode_s=enc_ms / 1e3, decode_s=dec_ms / 1e3, encode_launches=enc,
        decode_launches=dec)), flush=True)


def check_ranks(frames: np.ndarray, dev) -> dict:
    """Two ranks on the one card, each a subprocess with a timeout: the
    distributed encode equals the single-process file, and the decode is
    pixel-exact on both."""
    sub = np.ascontiguousarray(frames[:RANK_FRAMES])
    want = hashlib.sha256(encode_file_fpvt(
        sub, shift=SHIFT, frames_per_batch=MESH_FPB, chunk_log2=CHUNK_LOG2,
        device=dev)).hexdigest()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frames.npy")
        np.save(path, sub)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--rank-worker",
             str(r), str(port), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO) for r in range(RANKS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
        finally:
            for p in procs:
                p.kill()
                p.wait()
        wall = time.perf_counter() - t0
    rows = []
    for p, out in zip(procs, outs):
        if p.returncode:
            raise AssertionError(f"rank worker exit {p.returncode}:\n"
                                 f"{out[-3000:]}")
        rows += [json.loads(line[5:]) for line in out.splitlines()
                 if line.startswith("RANK ")]
    if [r["sha256"] for r in rows] != [want] * RANKS:
        raise AssertionError(f"rank files differ from the single-process "
                             f"file {want}: {rows}")
    return dict(frames=list(sub.shape), ranks=rows, wall_s=wall,
                sha256_equal=True, pixels="exact")


def check_coldstart() -> dict:
    """A fresh process (the kernels' library already built) from start to
    the end of one ``warmup_stream(1024, 1024, shift=4,
    frames_per_batch=16)``: no nvcc may run (the library's mtime stays)."""
    lib = kernels.library_path()
    before = lib.stat().st_mtime_ns
    code = ("import time; t0 = time.perf_counter()\n"
            "import torch, fpv_tpu_torch\n"
            "t1 = time.perf_counter()\n"
            f"fpv_tpu_torch.warmup_stream({W}, {H}, shift={SHIFT}, "
            f"frames_per_batch={MESH_FPB})\n"
            "torch.cuda.synchronize()\n"
            "print(t1 - t0, time.perf_counter() - t1)\n")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=WORKER_TIMEOUT)
    wall = time.perf_counter() - t0
    if p.returncode:
        raise AssertionError(f"cold start failed: {p.stderr[-3000:]}")
    if lib.stat().st_mtime_ns != before:
        raise AssertionError("the cold start rebuilt the kernels")
    import_s, warm_s = (float(v) for v in p.stdout.split())
    return dict(process_s=wall, import_s=import_s, warmup_s=warm_s,
                library=lib.name, rebuilt=False)


def check_trace(frames: np.ndarray, data: bytes, mesh, kw: dict) -> dict:
    """One D = 1 sharded encode + decode under ``profiling.trace``: the
    device busy share and the three longest kernels (the ``mesh.*``
    ranges carry device time too and are left out of both).  A first,
    empty trace starts the profiler's CUDA tracing outside the window."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").sum().item()
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profiling.trace(tmp) as prof:
            sharded_encode_file(frames, mesh, **kw)
            sharded_decode_file(data, mesh)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        traced = len(os.listdir(tmp))

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0)

    rows = [e for e in prof.key_averages() if dev_us(e) > 0
            and not e.key.startswith(("aten::", "mesh."))]
    kern = [e for e in rows if not e.key.startswith(("Memcpy", "Memset"))]
    busy = sum(dev_us(e) for e in rows) / 1e6
    spans = {e.key: e.count for e in prof.key_averages()
             if e.key.startswith("mesh.")}
    return dict(wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
                longest_kernels_ms_launches=[
                    (e.key[:60], dev_us(e) / 1e3, e.count)
                    for e in sorted(kern, key=lambda e: -dev_us(e))[:3]],
                spans=spans, trace_files=traced)


def check_mesh(frames: np.ndarray, data: bytes, out: np.ndarray, dev,
               card: str) -> dict:
    """The multi-device layer on the card (parallel/mesh.py,
    parallel/distributed.py): D = 1 over the card, D = 2 logical shards on
    it, the sharded codec round trip, the dry run, warmup_stream(mesh=),
    two gloo ranks, a cold start and a trace; each path counted."""
    t_phase = time.perf_counter()
    kw = dict(shift=SHIFT, frames_per_batch=FPB, chunk_log2=CHUNK_LOG2)
    row = dict(card=card, frames=list(frames.shape))
    k1 = ("rans_encode_chain", "rans_encode_place")
    want = expected_launches(data)
    mesh1 = make_mesh()

    got, l_enc = counted("mesh D=1 encode", k1,
                         lambda: sharded_encode_file(frames, mesh1, **kw))
    if got != data:
        raise AssertionError("D = 1 sharded file != encode_file_fpvt's")
    check_launches("mesh D=1 encode", l_enc, launches_of(want, True))
    dec, l_dec = counted("mesh D=1 decode", ("rans_decode",),
                         lambda: sharded_decode_file(data, mesh1))
    if not np.array_equal(dec, out):
        raise AssertionError("D = 1 sharded decode is not pixel-exact")
    check_launches("mesh D=1 decode", l_dec, launches_of(want, False))
    (dec, pv), l_pv = counted(
        "mesh D=1 previews", ("rans_decode",),
        lambda: sharded_decode_file(data, mesh1, want_previews=True))
    if not (np.array_equal(dec, out)
            and np.array_equal(pv, reader_previews(data, dev))):
        raise AssertionError("D = 1 sharded previews != the reader's")
    check_launches("mesh D=1 previews", l_pv,
                   launches_of(expected_launches(data, previews=True), False))
    row["d1"] = dict(encode_launches=l_enc, decode_launches=l_dec,
                     previews_launches=l_pv, bytes_equal=True,
                     pixels="exact", previews="equal the reader's")
    for name, fn in (
            ("sharded_encode", lambda: sharded_encode_file(frames, mesh1,
                                                           **kw)),
            ("encode_file_fpvt", lambda: encode_file_fpvt(frames, device=dev,
                                                          **kw)),
            ("sharded_decode", lambda: sharded_decode_file(data, mesh1)),
            ("decode_file_fpvt", lambda: decode_file_fpvt(data, device=dev))):
        row["d1"][f"{name}_s"] = runs3(fn)[1]

    mesh2 = make_mesh(devices=[dev, dev])
    kw16 = dict(kw, frames_per_batch=MESH_FPB)
    data16 = encode_file_fpvt(frames, device=dev, **kw16)
    want16 = expected_launches(data16)
    got, l_enc = counted("mesh D=2 encode", k1,
                         lambda: sharded_encode_file(frames, mesh2, **kw16))
    if got != data16:
        raise AssertionError("D = 2 sharded file != encode_file_fpvt's")
    check_launches("mesh D=2 encode", l_enc, launches_of(want16, True))
    dec, l_dec = counted("mesh D=2 decode", ("rans_decode",),
                         lambda: sharded_decode_file(data16, mesh2))
    if not np.array_equal(dec, out):
        raise AssertionError("D = 2 sharded decode is not pixel-exact")
    check_launches("mesh D=2 decode", l_dec, launches_of(want16, False))
    row["d2_logical"] = dict(frames_per_batch=MESH_FPB, bytes=len(data16),
                             encode_launches=l_enc, decode_launches=l_dec,
                             bytes_equal=True, pixels="exact")
    for name, fn in (
            ("sharded_encode", lambda: sharded_encode_file(frames, mesh2,
                                                           **kw16)),
            ("encode_file_fpvt", lambda: encode_file_fpvt(frames, device=dev,
                                                          **kw16)),
            ("sharded_decode", lambda: sharded_decode_file(data16, mesh2)),
            ("decode_file_fpvt", lambda: decode_file_fpvt(data16,
                                                          device=dev))):
        row["d2_logical"][f"{name}_s"] = runs3(fn)[1]
    del data16

    body = frames[1 : 1 + ROUNDTRIP_FRAMES]
    left = frames[0].astype(np.uint32) << SHIFT
    step = sharded_codec_roundtrip(mesh2, chunk_len=1 << CHUNK_LOG2,
                                   shift=SHIFT)
    (rec, ok), l_rt = counted("mesh roundtrip", (*k1, "rans_decode"),
                              lambda: step(body, (left >> 8) & 0xFF,
                                           left & 0xFF))
    if not ok or not np.array_equal(rec, body << SHIFT):
        raise AssertionError("sharded codec round trip failed")
    if [l_rt[k] for k in (*k1, "rans_decode")] != [2, 2, 2]:
        raise AssertionError(f"round trip launches {l_rt}: one grouped K1a, "
                             "K1b and K2 per shard expected")
    _none, rt_s = runs3(lambda: step(body, (left >> 8) & 0xFF, left & 0xFF))
    row["roundtrip"] = dict(frames=list(body.shape), shards=2,
                            chunk_len=1 << CHUNK_LOG2, ok=True,
                            launches=l_rt, wall_s=rt_s)
    del rec

    _none, dry_ms = timed_once(lambda: multichip_dryrun(2, mesh=mesh2))
    _none, warm_ms = timed_once(lambda: warmup_stream(
        W, H, shift=SHIFT, frames_per_batch=MESH_FPB, mesh=mesh2))
    row.update(dryrun_s=dry_ms / 1e3, warmup_mesh_s=warm_ms / 1e3)
    row["ranks"] = check_ranks(frames, dev)
    row["coldstart"] = check_coldstart()
    row["trace"] = check_trace(frames, data, mesh1, kw)
    row["phase_s"] = time.perf_counter() - t_phase
    print("mesh", json.dumps(row), flush=True)
    return row


FPVT_KERNELS = ("rans_encode_chain", "rans_encode_place", "rans_decode",
                "cg2d_decode")
FPV1_FRAMES, FPV1_THREADS = 64, 8  # bench.py:378's 64 frames


def fpv1_predicted(frames: np.ndarray, dev) -> tuple:
    """The FPV1 filter chain on the card over ``frames`` (frame 0 the delta
    frame) -> (the delta frame's predicted planes, the frames' predicted
    planes): the high residuals of USE_CG frames are what decode feeds K4."""
    enc = fpv1_encoder.Encoder(num_threads=0, shift=SHIFT, device=dev)
    imgs = enc._upload(frames)
    delta = frame_ops.split_planes(imgs[:1], SHIFT)
    pd = frame_ops.predict(delta, None, make_preview=False)
    delta = frame_ops.FramePlanes(high=delta.high[0], low=delta.low[0])
    return pd, frame_ops.predict(frame_ops.split_planes(imgs, SHIFT), delta)


def check_filter_chain(frames: np.ndarray, dev) -> dict:
    """The device filter chain (split, decision histograms, delta and CG
    residuals, previews) on the card equals the CPU's, on 8 crops of 256^2
    from the corpus after a delta frame."""
    sub = np.ascontiguousarray(frames[:9, 256:512, 384:640])
    outs = []
    for d in (dev, torch.device("cpu")):
        _pd, p = fpv1_predicted(sub, d)
        outs.append((p.flags, p.high.cpu(), p.low.cpu(), p.preview.cpu()))
    (fc, *tc), (fp, *tp) = outs
    err = max_err(tc, tp)
    if fc != fp or err:
        raise AssertionError(f"FPV1 filter chain: card != CPU ({err})")
    return dict(frames=list(sub.shape), flags=fc, max_abs_err=err)


def check_cg_flat(frames: np.ndarray, dev) -> list[dict]:
    """K4 against its plain version at the shapes the main path launches
    it: the delta frame's residual [1, H, W] and the CG frames' [k, H, W]
    of the first 64 corpus frames (one plain run over all of them: its
    chain is H*W steps whatever the batch), and 4 x 256^2.  Exact, and
    equal to the planes before the CG residual.  Bound: 1 byte in and 1
    out per pixel at 3.35 TB/s; its chain, H*W dependent steps per frame
    (``ns_per_step``)."""
    pd, p = fpv1_predicted(frames, dev)
    cg = [i for i, f in enumerate(p.flags) if f & frame_ops.FrameFlags.USE_CG]
    parts = ([("delta frame", pd.high)]
             if pd.flags[0] & frame_ops.FrameFlags.USE_CG else [])
    parts.append((f"{len(cg)} CG frames", p.high[cg].contiguous()))
    both = torch.cat([x for _n, x in parts])
    plain, plain_once = timed_once(lambda: predictors.cg_flat_decode_ref(both))
    rng = np.random.default_rng(2)
    small = torch.from_numpy(rng.integers(0, 256, (4, 256, 256), np.int64)
                             .astype(np.uint8)).to(dev)
    small_res = predictors.cg_flat_encode(small)
    small_plain, small_once = timed_once(
        lambda: predictors.cg_flat_decode_ref(small_res))
    rows, start = [], 0
    for name, res in parts:
        ref = plain[start : start + res.shape[0]]
        start += res.shape[0]
        rows.append((name, res, ref, plain_once, "one run over "
                     + str(list(both.shape))))
    rows.append(("4 x 256^2 random", small_res, small_plain, small_once,
                 "one run"))
    out = []
    for name, res, ref, once, timing in rows:
        got = predictors.cg_flat_decode(res)
        err = max_err((got,), (ref,))
        if err or not torch.equal(predictors.cg_flat_encode(got), res):
            raise AssertionError(f"K4 wrong on {name}: {err}")
        b, r, x = res.shape
        row = dict(case=f"{name} {list(res.shape)}",
                   ms=cuda_ms(lambda: predictors.cg_flat_decode(res), 5),
                   plain_ms=once, plain_timing=timing,
                   bound_ms=2 * res.numel() / HBM_BYTES_PER_MS,
                   chain_steps=r * x, max_abs_err=err)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["ns_per_step"] = row["ms"] * 1e6 / (r * x)
        print("cg_flat", json.dumps(row), flush=True)
        out.append(row)
    return out


def fpv1_cg_flags(data: bytes) -> tuple[bool, list[bool]]:
    """An FPV1 file's USE_CG flags: (the delta frame's, each frame's)."""
    cg = frame_ops.FrameFlags.USE_CG
    return bool(data[13] & cg), [
        bool(data[container.parse_frame_chunk(data, off).main_start] & cg)
        for off in container.parse_footer(data)]


def expected_k4(data: bytes) -> int:
    """K4 launches of ``decode_file`` on an FPV1 file of one decode batch:
    one for a CG delta frame, one for the batch if a frame is CG."""
    delta_cg, frames_cg = fpv1_cg_flags(data)
    return int(delta_cg) + int(any(frames_cg))


def fpv1_split(frames: np.ndarray, data: bytes, dev) -> dict:
    """Where an FPV1 round trip's time goes, each part synchronized on its
    own: the encode's device step (upload, filter chain, download, in
    ``ENCODE_BATCH`` steps) and its brotli (every frame's chunk on
    ``FPV1_THREADS`` threads); the decode's brotli (every frame's planes
    into the host batch on those threads) and its device step (upload,
    K4, delta add, combine, download)."""
    enc = fpv1_encoder.Encoder(num_threads=0, shift=SHIFT, device=dev)
    enc.init(frames[0], W, H, lambda d, p: None)

    def enc_device():
        items = []
        for s in range(0, len(frames), fpv1_encoder.ENCODE_BATCH):
            imgs = enc._upload(frames[s : s + fpv1_encoder.ENCODE_BATCH])
            items += fpv1_encoder._predicted_frames(frame_ops.predict(
                frame_ops.split_planes(imgs, SHIFT), enc._delta))
        return items

    items, dev_ms = timed_once(enc_device)
    ra = RandomAccessDecoder(device=dev)
    ra.init(data)
    mains = [ra._main(i) for i in range(ra.numframes)]
    n = len(mains)
    high = container._host_batch(n, H * W, dev)
    low = container._host_batch(n, H * W, dev)
    flags = [0] * n
    with ThreadPoolExecutor(FPV1_THREADS) as pool:
        _c, brotli_enc_ms = timed_once(
            lambda: list(pool.map(fpv1_encoder._frame_chunk, items)))

        def parse(j):
            flags[j] = container.parse_image(mains[j], W, H,
                                             high[j].numpy(), low[j].numpy())

        _p, brotli_dec_ms = timed_once(lambda: list(pool.map(parse,
                                                             range(n))))

    def dec_device():
        planes = frame_ops.FramePlanes(
            high=high.reshape(n, H, W).to(dev, non_blocking=True),
            low=low.reshape(n, H, W).to(dev, non_blocking=True), flags=flags)
        out = frame_ops.unpredict(planes, ra._delta)
        return fpv1_decoder._to_host_u16(
            frame_ops.combine_planes(out.high, out.low))

    got, dec_dev_ms = timed_once(dec_device)
    if not np.array_equal(got, frames << SHIFT):
        raise AssertionError("FPV1 split: the device step's frames differ")
    return dict(encode_device_step_s=dev_ms / 1e3,
                encode_brotli_s=brotli_enc_ms / 1e3,
                decode_brotli_s=brotli_dec_ms / 1e3,
                decode_device_step_s=dec_dev_ms / 1e3,
                brotli_threads=FPV1_THREADS)


def check_fpv1_reader(data: bytes, out: np.ndarray, dev) -> dict:
    """Random access, previews and the streaming decoder on the FPV1 main
    path's file, against its whole decode."""
    ra = RandomAccessDecoder(device=dev)
    if not ra.init(data):
        raise AssertionError("FPV1 file did not open")
    row = {}
    for i in (0, FPV1_FRAMES // 2, FPV1_FRAMES - 1):
        got, ms = timed_once(lambda: ra.decode_frame(i))
        row[f"decode_frame_{i}_s"] = ms / 1e3
        if not np.array_equal(got, out[i]):
            raise AssertionError(f"FPV1 decode_frame({i}) != full decode")
    high = torch.from_numpy((out >> 8).astype(np.uint8)).to(dev)
    want = generate_preview(high).cpu().numpy()
    pv, ms = timed_once(lambda: [ra.decode_preview(i)
                                 for i in range(ra.numframes)])
    row["decode_preview_each_s"] = ms / 1e3 / ra.numframes
    if not np.array_equal(np.stack(pv), want):
        raise AssertionError("FPV1 previews differ from the decoded frames'")
    got = []
    sd = StreamingDecoder(device=dev)

    def cb(ok, frame, xs, ys, p):
        if not ok:
            raise AssertionError("FPV1 streaming decoder failed a frame")
        got.append(frame)

    _n, ms = timed_once(lambda: [sd.decode(data[s : s + (1 << 20)], cb)
                                 for s in range(0, len(data), 1 << 20)])
    row["streaming_1mib_s"] = ms / 1e3
    if not np.array_equal(np.stack(got), out):
        raise AssertionError("FPV1 streaming decoder frames differ")
    return row


def check_fpv1(frames: np.ndarray, dev, card: str) -> tuple:
    """The FPV1 phase; prints the ``fpv1`` line -> (the K4 row of the
    kernels line, the 64-frame file), both None without libbrotli."""
    sub = np.ascontiguousarray(frames[:FPV1_FRAMES])
    row = dict(card=card, frames=list(sub.shape), shift=SHIFT,
               brotli_threads=FPV1_THREADS,
               filter_chain=check_filter_chain(frames, dev))
    cg_rows = check_cg_flat(sub, dev)
    if not brotli.available():
        row["brotli"] = "absent: the system libbrotli did not load; K4 and " \
                        "the filter chain were checked, the round trip not"
        print("fpv1", json.dumps(row), flush=True)
        return None, None

    def round_trip():
        enc_s, dec_s = [], []
        for _ in range(3):
            data, ms = timed_once(lambda: encode_file(
                sub, shift=SHIFT, num_threads=FPV1_THREADS, device=dev))
            enc_s.append(ms / 1e3)
        for _ in range(3):
            out, ms = timed_once(lambda: decode_file(
                data, num_threads=FPV1_THREADS, device=dev))
            dec_s.append(ms / 1e3)
        return data, out, enc_s, dec_s

    (data, out, enc_s, dec_s), launches = counted(
        "fpv1 main path", ("cg_flat_decode",), round_trip)
    if not np.array_equal(out, sub << SHIFT):
        raise AssertionError("FPV1 main path round trip is not lossless")
    if launches["cg_flat_decode"] != 3 * expected_k4(data):
        raise AssertionError(f"FPV1 K4 launches {launches}, want 3 x "
                             f"{expected_k4(data)}")
    mpix = sub.size / 1e6
    row.update(bytes=len(data), bits_per_pixel=len(data) * 8 / sub.size,
               encode_s=enc_s, decode_s=dec_s,
               encode_mpix_s=mpix / statistics.median(enc_s),
               decode_mpix_s=mpix / statistics.median(dec_s),
               launches=launches, lossless=True)
    small = testdata.plasma_frames(5, 96, 128, bits=BITS, seed=5)
    kw = dict(shift=SHIFT, num_threads=2)
    if encode_file(small, device=dev, **kw) != encode_file(small,
                                                           device="cpu", **kw):
        raise AssertionError("FPV1: card and CPU wrote different bytes")
    with np.load(GOLDEN / "inputs.npz") as z:
        drift = z["drift"]
    with open(GOLDEN / "hashes.json") as f:
        pin = json.load(f)["v1_drift.fpv"]

    def golden():
        got = decode_file((GOLDEN / "v1_drift.fpv").read_bytes(), device=dev)
        if not np.array_equal(got, drift << 4):
            raise AssertionError("golden v1_drift.fpv did not decode exactly")
        again = encode_file(drift, shift=4, num_threads=0, device=dev)
        if hashlib.sha256(again).hexdigest() != pin:
            raise AssertionError("golden v1_drift.fpv: the card's bytes differ")

    counted("fpv1 golden", (), golden)
    reader, _l = counted("fpv1 random access, previews, streaming",
                         ("cg_flat_decode",),
                         lambda: check_fpv1_reader(data, out, dev))
    row.update(reader=reader, small_file="card bytes == CPU bytes",
               golden="v1_drift.fpv decoded exactly, re-encoded to its pin",
               split=fpv1_split(sub, data, dev))
    print("fpv1", json.dumps(row), flush=True)
    k4 = cg_rows[-2]  # the CG frames' batch launch (the last is 4 x 256^2)
    k4_row = dict(
        name="cg_flat_decode", route="cuda",
        source="fpv_tpu_torch/csrc/cg_flat_decode.cu",
        replaces="fpv_tpu/models/predictors.py:103",
        replaces_note="a host scan of the JAX package, not a TPU kernel",
        launches=launches["cg_flat_decode"],
        max_abs_err=max(r["max_abs_err"] for r in cg_rows),
        ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
        bound_by="bytes", bound_share=k4["bound_share"], library_ms=None,
        shape=k4["case"], chain_steps=k4["chain_steps"],
        ns_per_step=k4["ns_per_step"], cases=cg_rows)
    return k4_row, data


TC_FPB = 16  # transcode_to_fpvt's default frames per batch
CLI_FRAMES = 9  # raw corpus frames the command-line tools encode
SMALL = (9, 64, 128)  # the small file of the card-vs-CPU checks
COL_FRAMES, COL_FPB = 32, 10  # columnar: tests/test_batch.py's batch size
REPO = pathlib.Path(__file__).resolve().parent


def runs3(fn) -> tuple:
    """A warm-up call of ``fn``, then three timed -> (the last result, the
    three wall times in s, each ending in a synchronize)."""
    fn()
    out, secs = None, []
    for _ in range(3):
        out, ms = timed_once(fn)
        secs.append(ms / 1e3)
    return out, secs


def transcode_k4(fpv1: bytes, fpb: int) -> int:
    """K4 launches of one ``transcode_to_fpvt`` of an FPV1 file whose
    frame 0 is its delta frame: one for a CG delta frame (at open), one
    per FPVT batch whose decode holds a CG frame (frame 0 decodes with
    the first batch)."""
    delta_cg, cg = fpv1_cg_flags(fpv1)
    chunks = [cg[: 1 + fpb]] + [cg[s : s + fpb]
                                for s in range(1 + fpb, len(cg), fpb)]
    return int(delta_cg) + sum(any(c) for c in chunks)


def check_launches(path: str, got: dict, want: dict) -> None:
    """``got`` (a counted run's launches) has ``want``'s counts, and no
    launch of a kernel ``want`` leaves out."""
    full = {name: want.get(name, 0) for name in got}
    if got != full:
        raise AssertionError(f"{path} launches {got}, want {full}")


def run_tool(tool: str, args: list, stdin: bytes = b"",
             device: str = "cuda") -> subprocess.CompletedProcess:
    """``python -m fpv_tpu_torch.cli.<tool> args --device <device>`` from
    the checkout; a non-zero exit fails with its stderr."""
    p = subprocess.run(
        [sys.executable, "-m", f"fpv_tpu_torch.cli.{tool}", *args,
         "--device", device],
        input=stdin, capture_output=True, cwd=REPO, timeout=600)
    if p.returncode:
        raise AssertionError(f"{tool} {args} --device {device}: exit "
                             f"{p.returncode}: {p.stderr[-2000:]!r}")
    return p


def run_tools(jobs: dict) -> dict:
    """name -> (tool, args, stdin[, device]) run at once, one process each
    -> name -> (completed process, wall s)."""
    def one(job):
        t0 = time.perf_counter()
        p = run_tool(*job)
        return p, time.perf_counter() - t0

    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {name: pool.submit(one, job) for name, job in jobs.items()}
        return {name: f.result() for name, f in futs.items()}


def check_cli(frames: np.ndarray, dev) -> dict:
    """The five tools in subprocesses on the card, all started at once:
    ``encode`` (both profiles) of 9 raw corpus frames, equal to the same
    encode in-process; ``decode`` of those files back to the raw bytes;
    ``transcode`` of them both ways, equal to the in-process transcoder's
    bytes; ``inspect --check`` on both; ``benchmark`` (both profiles) on a
    small raw file, and on it ``encode --device cpu`` against ``--device
    cuda`` in both profiles."""
    sub = np.ascontiguousarray(frames[:CLI_FRAMES])
    raw = testdata.to_raw_bytes(sub)
    wri = FpvtWriter(W, H, SHIFT, device=dev, delta_is_frame0=True,
                     narrow=False)
    files = {
        "fpv1": encode_file(sub, shift=SHIFT, num_threads=8, device=dev),
        "fpvt": b"".join([wri.init(sub[0])] + [
            wri.encode_batch(sub[s : s + wri.header.frames_per_batch])
            for s in range(1, CLI_FRAMES, wri.header.frames_per_batch)]
            + [wri.finish()]),
    }
    small = testdata.to_raw_bytes(
        testdata.plasma_frames(*SMALL, bits=BITS, seed=5))
    n, h, w = SMALL
    geo = [str(W), str(H), "0", str(SHIFT)]
    sgeo = [str(w), str(h), "0", str(SHIFT)]
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        small_path = pathlib.Path(tmp) / "small.raw"
        small_path.write_bytes(small)
        jobs = {
            "transcode fpv1->fpvt": ("transcode", ["fpvt", str(SHIFT)],
                                     files["fpv1"]),
            "transcode fpvt->fpv1": ("transcode", ["fpv1"], files["fpvt"]),
        }
        for prof, data in files.items():
            path = pathlib.Path(tmp) / prof
            path.write_bytes(data)
            jobs[f"encode {prof}"] = ("encode",
                                      [*geo, "8", "--profile", prof], raw)
            jobs[f"decode {prof}"] = ("decode", geo, data)
            jobs[f"inspect {prof}"] = ("inspect", ["--check", str(path)])
            jobs[f"benchmark {prof}"] = (
                "benchmark", [str(small_path), *sgeo, "0", "4",
                              "--profile", prof], b"")
            for d in ("cuda", "cpu"):
                jobs[f"small {prof} {d}"] = (
                    "encode", [*sgeo, "2", "--profile", prof], small, d)
        done = run_tools(jobs)
    out = {name: p.stdout for name, (p, _secs) in done.items()}
    for prof in files:
        if out[f"encode {prof}"] != files[prof]:
            raise AssertionError(f"cli encode {prof} != the in-process "
                                 "encode")
        if out[f"decode {prof}"] != raw:
            raise AssertionError(f"cli decode of the {prof} file != raw")
        if not out[f"inspect {prof}"].endswith(
                b"check: ok (all batches decode)\n"):
            raise AssertionError(f"cli inspect --check {prof} failed")
        if not done[f"benchmark {prof}"][0].stderr.endswith(b"ok\n"):
            raise AssertionError(f"cli benchmark {prof} did not end ok")
        if out[f"small {prof} cuda"] != out[f"small {prof} cpu"]:
            raise AssertionError(f"cli encode {prof}: --device cuda and "
                                 "--device cpu wrote different bytes")
    to_fpvt = out["transcode fpv1->fpvt"]
    if to_fpvt != transcode_to_fpvt(files["fpv1"], shift=SHIFT, device=dev):
        raise AssertionError("cli transcode fpvt != transcode_to_fpvt")
    if transcode_to_fpv1(to_fpvt, device=dev) != files["fpv1"]:
        raise AssertionError("cli transcode: FPV1 -> FPVT -> FPV1 != input")
    if out["transcode fpvt->fpv1"] != transcode_to_fpv1(files["fpvt"],
                                                        device=dev):
        raise AssertionError("cli transcode fpv1 != transcode_to_fpv1")
    return dict(raw_frames=list(sub.shape), small=list(SMALL),
                bytes={prof: len(d) for prof, d in files.items()},
                wall_s={name: secs for name, (_p, secs) in done.items()},
                exact=True)


def check_columnar(frames: np.ndarray, dev) -> dict:
    """``ColumnarBatchEncoder`` on 32 corpus frames (batches of 10) and
    ``ColumnarBatchDecoder`` as FULL (unshifted), MSB8 and PREVIEW on the
    card, exact, with one K4 launch per batch holding a CG frame; on a
    crop, the batches' arrays equal the CPU's."""
    sub = np.ascontiguousarray(frames[:COL_FRAMES])

    def encode(imgs, device):
        out = []
        h, w = imgs.shape[1:]
        enc = ColumnarBatchEncoder(w, h, SHIFT, False,
                                   lambda b: out.append(b) if b else None,
                                   frames_per_batch=COL_FPB, device=device)
        for i, img in enumerate(imgs):
            enc.push_frame(i, img).result(timeout=600)
        enc.join()
        return out

    batches, enc_ms = timed_once(lambda: encode(sub, dev))
    lengths = [b.length for b in batches]
    if lengths != [COL_FPB] * (COL_FRAMES // COL_FPB) + [COL_FRAMES % COL_FPB]:
        raise AssertionError(f"columnar batch lengths {lengths}")
    k4 = sum(any(f & frame_ops.FrameFlags.USE_CG for f in b._flags[: b.length])
             for b in batches)
    high = torch.from_numpy(((sub << SHIFT) >> 8).astype(np.uint8))
    want = {ImageType.FULL: sub.reshape(COL_FRAMES, -1),
            ImageType.MSB8: high.numpy().reshape(COL_FRAMES, -1),
            ImageType.PREVIEW: generate_preview(high.to(dev)).cpu().numpy()
            .reshape(COL_FRAMES, -1)}
    row = dict(frames=list(sub.shape), frames_per_batch=COL_FPB,
               batches=lengths, encode_s=enc_ms / 1e3, expected_k4=k4)
    for type, unshift in ((ImageType.FULL, True), (ImageType.MSB8, False),
                          (ImageType.PREVIEW, False)):
        images = []

        def decode():
            dec = ColumnarBatchDecoder(type, unshift, images.append,
                                       device=dev)
            for b in batches:
                dec.push_batch(b).result(timeout=600)
            dec.join()

        (_n, ms), launches = counted(f"columnar {type.name}",
                                     ("cg_flat_decode",) if k4 else (),
                                     lambda: timed_once(decode))
        check_launches(f"columnar {type.name}", launches,
                       {"cg_flat_decode": k4})
        got = np.stack([img.data16() if type == ImageType.FULL
                        else img.data8() for img in images])
        if not np.array_equal(got, want[type]):
            raise AssertionError(f"columnar {type.name} decode is not exact")
        row[f"decode_{type.name.lower()}_s"] = ms / 1e3
    crop = np.ascontiguousarray(frames[:12, :64, :96])
    card, cpu = encode(crop, dev), encode(crop, "cpu")
    if [b.length for b in card] != [b.length for b in cpu] or not all(
            np.array_equal(x._buffer, y._buffer) for x, y in zip(card, cpu)):
        raise AssertionError("columnar: card and CPU batches differ")
    row.update(crop=list(crop.shape), crop_card_equals_cpu=True, exact=True)
    return row


def check_arrow(frames: np.ndarray, dev) -> dict:
    """The Arrow round trip on 8 corpus crops of 256^2 on the card, with
    one K4 launch per RecordBatch holding a CG plane, when pyarrow is
    installed; which of the two happened is printed."""
    if importlib.util.find_spec("pyarrow") is None:
        print("arrow: pyarrow is not installed; the Arrow round trip was "
              "not run", flush=True)
        return dict(ran=False)
    from fpv_tpu_torch.batch.arrow import ArrowEncoder, decode_record_batch

    crop = np.ascontiguousarray(frames[:8, :256, :256])
    h, w = crop.shape[1:]
    rbs = []
    enc = ArrowEncoder(w, h, SHIFT, False,
                       lambda rb: rbs.append(rb) if rb else None,
                       frames_per_batch=COL_FPB, device=dev)
    for i, img in enumerate(crop):
        enc.push_frame(i, img).result(timeout=600)
    enc.join()
    k4 = sum(rb.schema.metadata[b"deltaFrameCGPredicted"] == b"true"
             or any(rb.column("cgPredicted").to_pylist()) for rb in rbs)
    got, launches = counted(
        "arrow", ("cg_flat_decode",) if k4 else (),
        lambda: [f for rb in rbs for f in decode_record_batch(rb, device=dev)])
    check_launches("arrow", launches, {"cg_flat_decode": k4})
    if not np.array_equal(np.stack(got), crop << SHIFT):
        raise AssertionError("arrow round trip is not exact")
    print("arrow: pyarrow is installed; the Arrow round trip ran, exact",
          flush=True)
    return dict(ran=True, frames=list(crop.shape), record_batches=len(rbs),
                launches=launches, exact=True)


def transcode_split(data: bytes, fpvt_data: bytes, dev) -> dict:
    """Where a transcode's time goes, each half synchronized on its own:
    FPV1 -> FPVT as the FPV1 decode (open with the delta frame's K4,
    brotli on 4 threads, one K4 per batch) and the FPVT writer on the
    decoded device frames; FPVT -> FPV1 as the FPVT decode (K2, K3,
    device frames) and the FPV1 encoder (device step, brotli on 4
    threads) on them."""
    fpb = TC_FPB

    def fpv1_decode():
        dec = RandomAccessDecoder(device=dev)
        dec.init(data)
        with ThreadPoolExecutor(4) as pool:
            return [dec._decode_frames_device(range(s, min(s + fpb,
                                                           dec.numframes)),
                                              pool)
                    for s in range(0, dec.numframes, fpb)]

    parts, dec_ms = timed_once(fpv1_decode)
    wri = FpvtWriter(W, H, SHIFT, False, fpb, CHUNK_LOG2, device=dev,
                     delta_is_frame0=True, narrow=False)

    def fpvt_encode():
        wri._init_core(parts[0][:1] >> SHIFT, SHIFT, False)
        for p in parts:
            wri._encode_batch_core(p >> SHIFT, SHIFT, False, None)

    _n, enc_ms = timed_once(fpvt_encode)
    r = FpvtReader(fpvt_data, device=dev)

    def fpvt_decode():
        fins = [r._decode_parsed_batch_issue(r._parse_batch(off), b,
                                             device_frames=True)
                for off, b in r._batches]
        return [fin()[0] for fin in fins]

    frames, fdec_ms = timed_once(fpvt_decode)
    enc = fpv1_encoder.Encoder(num_threads=4, shift=SHIFT, device=dev)
    enc.init(r.delta_frame() >> SHIFT, W, H, lambda d, p: None)

    def fpv1_encode():
        for f in frames:
            enc._compress_batch(f >> SHIFT, [(lambda d, p: None, None)]
                                * f.shape[0])
        enc.finish(lambda d, p: None)

    _n, fenc_ms = timed_once(fpv1_encode)
    return {"fpv1->fpvt": dict(fpv1_decode_s=dec_ms / 1e3,
                               fpvt_encode_s=enc_ms / 1e3),
            "fpvt->fpv1": dict(fpvt_decode_s=fdec_ms / 1e3,
                               fpv1_encode_s=fenc_ms / 1e3)}


def check_transcode(data: bytes, frames: np.ndarray, dev, card: str) -> dict:
    """FPV1 -> FPVT -> FPV1 of the FPV1 phase's 64-frame file on the card
    (a warm-up call and three timed each way, counted: K4 once per FPVT
    batch plus the delta frame's, K1a/K1b per batch and coded delta plane;
    then K2 per batch plus the delta section's, K3 where a section picked
    CG2D), returning the input exactly; card bytes equal CPU bytes on a
    small file; the tools, the columnar round trip and the Arrow round
    trip.  Prints the ``transcode`` line."""
    t_phase = time.perf_counter()
    sub = frames[:FPV1_FRAMES]
    mpix = sub.size / 1e6
    k1 = ("rans_encode_chain", "rans_encode_place")
    (fpvt_data, to_fpvt_s), l_fpvt = counted(
        "transcode fpv1->fpvt", ("cg_flat_decode", *k1),
        lambda: runs3(lambda: transcode_to_fpvt(data, shift=SHIFT,
                                                device=dev)))
    hdr = fpvt.Header.parse(fpvt_data)
    if not hdr.delta_is_frame0 or hdr.shift != SHIFT:
        raise AssertionError(f"transcoded header {hdr}")
    want = expected_launches(fpvt_data)
    calls = 4  # the warm-up and three timed
    check_launches("transcode fpv1->fpvt", l_fpvt, {
        "cg_flat_decode": calls * transcode_k4(data, TC_FPB),
        "rans_encode_chain": calls * want["k1"],
        "rans_encode_place": calls * want["k1"]})
    if not np.array_equal(decode_file_fpvt(fpvt_data, device=dev),
                          sub << SHIFT):
        raise AssertionError("the transcoded FPVT does not decode to the "
                             "frames")
    (back, to_fpv1_s), l_fpv1 = counted(
        "transcode fpvt->fpv1",
        ("rans_decode",) + (("cg2d_decode",) if want["k3"] else ()),
        lambda: runs3(lambda: transcode_to_fpv1(fpvt_data, device=dev)))
    check_launches("transcode fpvt->fpv1", l_fpv1, {
        "rans_decode": calls * want["k2"], "cg2d_decode": calls * want["k3"]})
    if back != data:
        raise AssertionError("FPV1 -> FPVT -> FPV1 did not return the input")
    small = testdata.plasma_frames(*SMALL, bits=BITS, seed=5)
    s1 = encode_file(small, shift=SHIFT, num_threads=2, device="cpu")
    kw = dict(shift=SHIFT, frames_per_batch=4)
    on_card = transcode_to_fpvt(s1, device=dev, **kw)
    if (on_card != transcode_to_fpvt(s1, device="cpu", **kw)
            or transcode_to_fpv1(on_card, device=dev) != s1
            or transcode_to_fpv1(on_card, device="cpu") != s1):
        raise AssertionError("transcode: card and CPU bytes differ")
    row = dict(
        card=card, frames=list(sub.shape), shift=SHIFT,
        frames_per_batch=TC_FPB, fpv1_bytes=len(data),
        fpvt_bytes=len(fpvt_data), to_fpvt_s=to_fpvt_s, to_fpv1_s=to_fpv1_s,
        to_fpvt_mpix_s=mpix / statistics.median(to_fpvt_s),
        to_fpv1_mpix_s=mpix / statistics.median(to_fpv1_s),
        launches_per_call={
            "fpv1->fpvt": {k: v // calls for k, v in l_fpvt.items()},
            "fpvt->fpv1": {k: v // calls for k, v in l_fpv1.items()}},
        round_trip="FPV1 -> FPVT -> FPV1 returned the input file",
        small_file=f"{SMALL}: card bytes == CPU bytes both ways",
        split=transcode_split(data, fpvt_data, dev))
    row["cli"] = check_cli(frames, dev)
    row["columnar"] = check_columnar(frames, dev)
    row["arrow"] = check_arrow(frames, dev)
    row["phase_s"] = time.perf_counter() - t_phase
    print("transcode", json.dumps(row), flush=True)
    return row


BOUND_SMALL = dict(nblocks=3, chunk_len=64)  # nsub 2, 4, 8 do not divide 3
BOUND_REPORT = dict(nblocks=64, chunk_len=rans_bound.CHUNK_LEN)
LARGE = dict(size=4096, frames=4, chunks=[11, 12, 13], reps=3)


def kernel_label(mangled: str) -> str:
    """A kernel's readable name from its mangled one: the variants by
    ``rans_bound.variant_label``, K1a's nsub by its chain count."""
    m = re.search(r"rans_decode_variant_kernelILb(\d)ENS_7VariantILb(\d)ELb"
                  r"(\d)ELi(\d+)ELi(\d+)ELb(\d)ELi(\d+)E", mangled)
    if m:
        ctx, st, sw, cls, pb, two, nsub = (int(g) for g in m.groups())
        return "rans_decode_variant " + rans_bound.variant_label(
            (bool(ctx), bool(st), bool(sw), cls, 7 if ctx else pb,
             not two, nsub))
    m = re.search(r"rans_encode_chain_nsub_kernelILi(\d+)E", mangled)
    if m:
        return f"rans_encode_chain nsub{m.group(1)}"
    for kern in ("rans_encode_chain_kernel", "rans_encode_place_kernel",
                 "rans_decode_kernel", "cg2d_decode_kernel",
                 "cg_flat_decode_kernel"):
        if kern in mangled:
            return kern
    return mangled


def ptxas_report() -> dict:
    """Registers and spill bytes of every kernel in the library, from the
    ptxas report kept beside it: {kernel: [registers, spill stores, spill
    loads]}."""
    log = kernels.library_path().with_suffix(".log").read_text()
    out, name, spills = {}, None, [0, 0]
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spills = [int(w) for w in line.split() if w.isdigit()][1:3]
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used")[1].split()[0])
            out[kernel_label(name)] = [regs, *spills]
            name = None
    return out


def busy_ms(fn) -> float:
    """``fn``'s time on the card in ms as the reports take it
    (``rans_bound._time_interleaved``: calls queued back to back behind
    an untimed one, best of 5), so that wrappers' host work is not
    timed."""
    return rans_bound._time_interleaved([fn], reps=5)[0] * 1e3


def check_variants(dev) -> list[dict]:
    """Every K2 variant on the card against its plain version (on the same
    card tensors), bit for bit, at BOUND_SMALL and at the reports' shape;
    the decoding ones also against the stream's symbols.  Times the
    kernel (:func:`busy_ms`), K2 on the same planes where it reads them
    (``k2_ms``), and the plain version (one run) at the reports' shape;
    the bound is K2's bytes there."""
    rows = []
    for key in sorted(rans_cuda.VARIANTS):
        row = dict(case=rans_bound.variant_label(key))
        for where, shape in (("small", BOUND_SMALL), ("report",
                                                      BOUND_REPORT)):
            planes, flags, want = rans_bound.variant_case(key, device=dev,
                                                          **shape)
            got = rans_cuda.rans_decode_variant(planes, **flags)
            ref, plain_ms = timed_once(lambda: [
                rans_cuda.rans_decode_variant_ref(*p, **flags)
                for p in planes])
            err = max(max_err(g, r) for g, r in zip(got, ref))
            if want is not None:
                err = max(err, max_err((got[0][0],), (want,)))
                if not bool((got[0][1] == 1).all()):
                    raise AssertionError(f"{row['case']}: ok flags not set")
            if err:
                raise AssertionError(f"{row['case']} {where}: kernel != "
                                     f"plain ({err})")
            row[f"{where}_blocks"] = int(planes[0].states.shape[0])
            row["max_abs_err"] = err
        p = planes[0]
        row.update(
            chunk_len=p.chunk_len,
            ms=busy_ms(lambda: rans_cuda.rans_decode_variant(planes,
                                                             **flags)),
            # K2 itself, where the planes carry its table
            k2_ms=busy_ms(lambda: rans_cuda.rans_decode_grouped(planes))
            if p.table.numel() == 4096 and p.prob_bits in (7, 12) else None,
            plain_ms=plain_ms, plain_timing="one run",
            bound_bytes=nbytes(p.counts, p.starts, p.states, p.lens,
                               p.table, p.payload, *got[0]),
            decodes_the_stream=want is not None)
        row["bound_ms"] = row["bound_bytes"] / HBM_BYTES_PER_MS
        print("variant", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def check_encode_nsub(dev) -> list[dict]:
    """K1a with nsub 2, 4, 8 chains per thread against K1a and its plain
    version (on the same card tensors) at BOUND_SMALL and at the reports'
    shape, bit for bit; times at the reports' shape (K1a's bound there:
    its inputs, states and counts)."""
    rows = []
    for nsub in (2, 4, 8):
        row = dict(case=f"order0 nsub{nsub}", lanes=1024)
        for where, nb in (("small", BOUND_SMALL["nblocks"]),
                          ("report", BOUND_REPORT["nblocks"])):
            plane, _n = rans_bound._build_encode_args(nb, device=dev)
            got = rans_cuda.rans_encode_chain([plane], nsub=nsub)[0]
            ref = rans_cuda.rans_encode_chain([plane])[0]
            plain, plain_ms = timed_once(
                lambda: rans_cuda.rans_encode_chain_ref(*plane))
            err = max(max_err(got, ref), max_err(got, plain))
            if err:
                raise AssertionError(f"K1a nsub {nsub} {where}: {err}")
            row[f"{where}_blocks"] = nb
        row.update(
            chunk_len=rans_bound.CHUNK_LEN, max_abs_err=0,
            chain_ms=busy_ms(
                lambda: rans_cuda.rans_encode_chain([plane], nsub=nsub)),
            chain_k1a_ms=busy_ms(
                lambda: rans_cuda.rans_encode_chain([plane])),
            chain_plain_ms=plain_ms, plain_timing="one run",
            bound_bytes=nbytes(plane.syms, plane.lens, plane.fc, got[0],
                               got[3]))
        row["bound_ms"] = row["bound_bytes"] / HBM_BYTES_PER_MS
        print("k1a nsub", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def check_studies(dev) -> dict:
    """The entropy studies at ``--fast`` on the card: every corpus's
    numbers equal the CPU's (the same integer residuals, the same
    entropies)."""
    out = {}
    for mod in (temporal_study, class_tables_study, ctx_study):
        name = mod.__name__.rsplit(".", 1)[1]
        rows = []
        for corpus, frames, shift in temporal_study.corpora(4, 128,
                                                           mod.CORPORA):
            card = mod.study(corpus, frames, shift, device=dev)
            if card != mod.study(corpus, frames, shift, device="cpu"):
                raise AssertionError(f"{name} {corpus}: card != CPU")
            rows.append(card)
        out[name] = rows
    return out


def check_bound(dev, card: str) -> tuple[dict, list, list]:
    """The measurement phase (docstring item 13) -> (the ``bound`` line,
    the variant rows, the K1a nsub rows)."""
    t_phase = time.perf_counter()
    variants = check_variants(dev)
    enc_nsub = check_encode_nsub(dev)

    def reports():
        rep = dict(
            bound=rans_bound.bound_report(device=dev),
            nsub_order0=rans_bound.nsub_report(device=dev),
            nsub_ctx=rans_bound.nsub_report(ctx=True, device=dev),
            nsub_encode=rans_bound.nsub_encode_report(device=dev),
            fused_rows=rans_bound.fused_rows_report(device=dev),
            class_tables=rans_bound.class_tables_report(device=dev))
        t0 = time.perf_counter()
        rep["large_frame"] = large_frame_study.run(device=dev, **LARGE)
        rep["large_frame"]["wall_s"] = time.perf_counter() - t0
        return rep

    rep, launches = counted(
        "bound", ("rans_decode_variant", "rans_decode", "rans_encode_chain",
                  "rans_encode_place"), reports)
    b = rep["bound"]
    row = dict(
        card=card,
        decode_bound_fraction=b["decode_bound_fraction"],
        core_fraction=b["core_fraction"],
        step_full_ns=b["step_full_ns"], step_chain_ns=b["step_chain_ns"],
        step_core_ns=b["step_core_ns"], **rep,
        studies_fast=check_studies(dev),
        launches=launches, ptxas=ptxas_report())
    row["phase_s"] = time.perf_counter() - t_phase
    print("bound", json.dumps(row), flush=True)
    return row, variants, enc_nsub


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
    refs = check_rans(cases, dev, rans_rows)
    # the main path's batch: high, ctx16 low and preview encode together;
    # high and low decode together
    grouped = check_rans_grouped(cases, refs, (0, 2, 1), (0, 2))
    check_cg2d(m["high"], m["preview"], dev, cg_rows)
    del m, cases, refs
    narrow = narrow_cases(dev)
    check_rans(narrow[:2], dev, rans_rows)
    check_rans(narrow[2:], dev, rans_rows, plain_reps=0)
    del narrow
    torch.cuda.empty_cache()

    # the main path, counted
    enc_launches = {}

    def round_trip():
        t0 = time.perf_counter()
        data = encode_file_fpvt(frames, shift=SHIFT, frames_per_batch=FPB,
                                chunk_log2=CHUNK_LOG2, device=dev)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        enc_launches.update(kernels.LAUNCHES)
        t0 = time.perf_counter()
        out = decode_file_fpvt(data, device=dev)
        torch.cuda.synchronize()
        return data, out, t_enc, time.perf_counter() - t0

    (data, out, t_enc, t_dec), launches = counted(
        "main path", FPVT_KERNELS, round_trip
    )
    if out.shape != frames.shape or not np.array_equal(out, frames << SHIFT):
        raise AssertionError("main path round trip is not lossless")
    dec_launches = {k: v - enc_launches[k] for k, v in launches.items()}
    check_grouped_launches(data, enc_launches, dec_launches)
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

    k1 = ("rans_encode_chain", "rans_encode_place")
    counted("golden", (*k1, "rans_decode"), lambda: check_golden(dev))
    counted("narrow max", (*k1, "rans_decode"),
            lambda: check_narrow_max(dev))
    row, _ = counted("random access", ("rans_decode",),
                     lambda: check_reader(data, out, dev))
    print("random access", json.dumps(row), flush=True)
    row, pv_launches = counted("previews", ("rans_decode", "cg2d_decode"),
                               lambda: check_previews(data, out, dev))
    print("previews", json.dumps(row), flush=True)
    counted("streaming", ("rans_decode",),
            lambda: check_streaming(data, out, dev))

    # the serving hubs, each phase counted on its own
    _none, dec_ms = timed_once(lambda: decode_file_fpvt(data, device=dev))
    dec_s = dec_ms / 1e3
    hubs = dict(card=card, frames=list(frames.shape), decode_file_fpvt_s=dec_s,
                decode_file_fpvt_mpix_s=mpix / dec_s)
    hubs.update(check_encode_hub(frames, dev))
    hubs.update(check_decode_hub(data, out, dev))
    hubs.update(check_replay(data, out, dev))
    print("hubs", json.dumps(hubs), flush=True)
    print("card fuzz", json.dumps(check_fuzz(data, out, dev)), flush=True)
    check_mesh(frames, data, out, dev, card)
    del out, data
    torch.cuda.empty_cache()

    k4_row, fpv1_data = check_fpv1(frames, dev, card)
    if fpv1_data is None:
        print("transcode: not run: the FPV1 phase had no libbrotli",
              flush=True)
    else:
        check_transcode(fpv1_data, frames, dev, card)
    del frames
    torch.cuda.empty_cache()
    bound, variants, enc_nsub = check_bound(dev, card)

    err = max(r["max_abs_err"] for r in rans_rows + [grouped])

    def cases_line(*keys):
        return [dict(case=r["case"], lanes=r["lanes"], k=r["chunk_len"],
                     plain_timing=r["plain_timing"],
                     max_abs_err=r["max_abs_err"],
                     **{key: r[key] for key in keys}) for r in rans_rows]

    def rans_kernel(name, source, replaces, key, cases):
        row = dict(
            name=name, route="cuda", source=f"fpv_tpu_torch/csrc/{source}",
            replaces=replaces, launches=launches[name], max_abs_err=err,
            ms=grouped[f"{key}_ms"], plain_ms=grouped[f"{key}_plain_ms"],
            bound_ms=grouped[f"{key}_bound_ms"], bound_by="bytes",
            library_ms=None, shape="one main-path batch: "
            + " + ".join(grouped["decoded_planes" if key == "dec"
                                 else "planes"]),
            bound_bytes=grouped[f"{key}_bytes"])
        if key != "dec":
            # the pass's share of K1's bound, K1 whole beside it
            row.update(traffic_bytes=grouped[f"{key}_traffic_bytes"],
                       k1_ms=grouped["k1_ms"],
                       k1_bound_ms=grouped["k1_bound_ms"],
                       k1_bound_share=grouped["k1_bound_share"])
        row["cases"] = cases
        return row

    enc_src = ("rans_encode.cu", "fpv_tpu/ops/rans_pallas.py:880")
    headline = next(r for r in variants if r["case"] == "order0-nsub2")
    variant_kernel = dict(
        name="rans_decode_variant", route="cuda",
        source="fpv_tpu_torch/csrc/rans_decode_variants.cu",
        replaces="fpv_tpu/ops/rans_pallas.py:999",
        launches=bound["launches"]["rans_decode_variant"],
        max_abs_err=max(r["max_abs_err"] for r in variants),
        ms=headline["ms"], plain_ms=headline["plain_ms"],
        bound_ms=headline["bound_ms"], bound_by="bytes", library_ms=None,
        shape=f"order0-nsub2, {headline['report_blocks']} blocks x "
        f"{headline['chunk_len']} steps x 1024 lanes (the reports' shape)",
        bound_bytes=headline["bound_bytes"], cases=variants)
    kernels_line = {"kernels": [
        rans_kernel("rans_encode_chain", *enc_src, "chain",
                    cases_line("chain_ms", "chain_plain_ms", "enc_ms")
                    + enc_nsub),
        rans_kernel("rans_encode_place", *enc_src, "place",
                    cases_line("place_ms", "place_plain_ms")),
        rans_kernel("rans_decode", "rans_decode.cu",
                    "fpv_tpu/ops/rans_pallas.py:999", "dec",
                    cases_line("dec_ms", "dec_plain_ms")),
        dict(name="cg2d_decode", route="cuda",
             source="fpv_tpu_torch/csrc/cg2d_decode.cu",
             replaces="fpv_tpu/ops/predict.py:231",
             launches=launches["cg2d_decode"],
             preview_launches=pv_launches["cg2d_decode"],
             max_abs_err=max(r["max_abs_err"] for r in cg_rows),
             ms=cg_rows[0]["ms"], plain_ms=cg_rows[0]["plain_ms"],
             bound_ms=cg_rows[0]["bound_ms"], bound_by="bytes",
             bound_share=cg_rows[0]["bound_share"],
             library_ms=None, shape=cg_rows[0]["case"], cases=cg_rows),
        variant_kernel,
    ] + ([k4_row] if k4_row else [])}
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        rank_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()

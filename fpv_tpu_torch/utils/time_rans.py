"""K1 (rANS encode) and K2 (rANS decode) timed on single planes.

    python3 -m fpv_tpu_torch.utils.time_rans [--tag NAME] [--reps 10]
    PYTHONPATH=<other checkout> python3 fpv_tpu_torch/utils/time_rans.py \\
        --tag other

Codes one plane of seeded skewed symbols at each geometry the codec uses,
from the narrowest stream (8 lanes x 16 steps, a plane batch of at most
128 symbols) through the narrow maximum (128 lanes x 32768 steps) to a
main-path plane (8 blocks of 1024 lanes x 4096 steps), and prints one
JSON line per geometry: the median CUDA-event time of the encode wrapper
(K1, as the plane codec calls it, with its pull of the counts) and of the
decode wrapper (K2, on a payload laid out as the reader uploads it), after
checking that the decode inverts the encode.

The inputs depend only on the seed, so the script times any checkout of
the package on the same planes: run it once per checkout in one call to
the card (the second form above imports the package from another
checkout, whose one-plane wrappers it then calls) and compare within the
call.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from fpv_tpu_torch.entropy.plane_codec import ctx_indices_device
from fpv_tpu_torch.entropy.tables import normalize_freqs, normalize_freqs_ctx
from fpv_tpu_torch.ops import rans_cuda
from fpv_tpu_torch.ops.rans_layout import CTX_PROB_BITS, PROB_BITS, chunk_lens
from fpv_tpu_torch.utils import kernels

# (lanes, chunk_len, blocks, ctx16)
GEOMETRIES = (
    (8, 16, 1, False),
    (8, 1024, 1, False),
    (8, 1024, 1, True),
    (8, 32768, 1, False),
    (128, 32768, 1, False),
    (128, 32768, 1, True),
    (1024, 4096, 8, False),
    (1024, 4096, 8, True),
)


def plane(lanes: int, k: int, blocks: int, ctx: bool, dev):
    """Seeded skewed symbols filling ``blocks`` blocks (the last lane one
    symbol short), their lane lengths and both tables, on ``dev``."""
    n = blocks * k * lanes - 1
    rng = np.random.default_rng(lanes * 7 + k + ctx)
    flat = np.minimum(rng.geometric(0.3, n) - 1, 15 if ctx else 255)
    lens = chunk_lens(1, n, k, lanes).reshape(blocks, lanes)
    syms = np.zeros(blocks * k * lanes, np.uint8)
    syms[:n] = flat
    syms = torch.from_numpy(syms.reshape(blocks, k, lanes))
    if ctx:
        jhist = torch.bincount(ctx_indices_device(syms).reshape(-1),
                               minlength=512).numpy()
        freq = normalize_freqs_ctx(jhist, floor_mask=jhist > 0)
        fc = rans_cuda.ctx_table_arrays(freq)
        table = rans_cuda.ctx_fused_table_arrays(freq)
    else:
        freq = normalize_freqs(np.bincount(flat, minlength=256),
                               ensure_all=True)
        fc = rans_cuda.table_arrays(freq)
        table = rans_cuda.fused_table_arrays(freq)
    return (syms.to(dev), torch.from_numpy(lens).to(dev),
            rans_cuda.u32_tensor(fc, dev), rans_cuda.u32_tensor(table, dev))


def wrappers():
    """(encode, decode, stage) of the imported package: its grouped
    wrappers called on one plane, or a checkout's one-plane wrappers where
    it has no grouped ones."""
    if hasattr(rans_cuda, "rans_encode_grouped"):
        return (lambda *a: rans_cuda.rans_encode_grouped(
                    [rans_cuda.EncodePlane(*a)])[0],
                lambda *a: rans_cuda.rans_decode_grouped(
                    [rans_cuda.DecodePlane(*a)])[0],
                rans_cuda.staged_payload)
    return rans_cuda.rans_encode, rans_cuda.rans_decode, lambda p: p


def cuda_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` on the card in ms (CUDA events), after
    one warm-up call."""
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_rans: torch.cuda.is_available() is false")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    kernels.library()
    encode, decode, stage = wrappers()
    for lanes, k, blocks, ctx in GEOMETRIES:
        syms, lens, fc, table = plane(lanes, k, blocks, ctx, dev)
        pb = CTX_PROB_BITS if ctx else PROB_BITS
        states, counts, payload = encode(syms, lens, fc, pb, ctx)
        starts = torch.cumsum(counts.to(torch.int64), 0) - counts
        dec_args = (counts, starts, states, lens, table, stage(payload), k,
                    pb, ctx)
        got, ok = decode(*dec_args)
        if not torch.equal(got, syms) or not bool((ok == 1).all()):
            raise AssertionError(f"decode did not invert encode at "
                                 f"{lanes} x {k}")
        print(json.dumps(dict(
            tag=args.tag, lanes=lanes, k=k, blocks=blocks, ctx=ctx,
            words=int(payload.numel()),
            enc_ms=cuda_ms(lambda: encode(syms, lens, fc, pb, ctx),
                           args.reps),
            dec_ms=cuda_ms(lambda: decode(*dec_args), args.reps))),
            flush=True)


if __name__ == "__main__":
    main()

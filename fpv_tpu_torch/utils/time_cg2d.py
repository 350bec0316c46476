"""K3 (CG2D wavefront inverse) timed at the shapes the main path launches.

    python3 -m fpv_tpu_torch.utils.time_cg2d [--tag NAME] [--reps 10]
    PYTHONPATH=<other checkout> python3 fpv_tpu_torch/utils/time_cg2d.py \\
        --tag other

Decodes the CG2D residual of seeded u8 frames with ``predict.cg2d_decode``
at [1,1024,1024] (a file's delta section), [32,1024,1024] (a batch whose
frames pick CG2D), [32,256,256] (a batch's previews) and [1,65536,64] (the
format's tallest frame), checks that it returns the frames, and prints one
JSON line per shape: the median CUDA-event time of the wrapper, ns per
anti-diagonal (H + W - 1 of them), and the byte bound (1 B in, 1 B out per
pixel at 3.35 TB/s) with the share of it reached.

The inputs depend only on the seed, so the script times any checkout of
the package on the same frames: run it once per checkout in one call to
the card (the second form above imports the package from another
checkout) and compare within the call.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from fpv_tpu_torch.ops import predict
from fpv_tpu_torch.utils import kernels
from fpv_tpu_torch.utils.time_rans import cuda_ms

SHAPES = ((1, 1024, 1024), (32, 1024, 1024), (32, 256, 256), (1, 65536, 64))
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM: 3.35 TB/s


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_cg2d: torch.cuda.is_available() is false")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    kernels.library()
    for shape in SHAPES:
        rng = np.random.default_rng(sum(shape))
        plane = torch.from_numpy(
            rng.integers(0, 256, shape, np.int64).astype(np.uint8)).to(dev)
        res = predict.cg2d_encode(plane)
        if not torch.equal(predict.cg2d_decode(res), plane):
            raise AssertionError(f"K3 did not invert the residual at {shape}")
        ms = cuda_ms(lambda: predict.cg2d_decode(res), args.reps)
        bound = 2 * plane.numel() / HBM_BYTES_PER_MS
        print(json.dumps(dict(
            tag=args.tag, shape=list(shape), ms=ms,
            ns_per_diagonal=ms * 1e6 / (shape[1] + shape[2] - 1),
            bound_ms=bound, bound_share=bound / ms)), flush=True)


if __name__ == "__main__":
    main()

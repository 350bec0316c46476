"""Where a row's time goes in K4's scan: SM cycles per phase.

    python3 -m fpv_tpu_torch.utils.profile_cg_flat [--reps 2]

Builds a copy of ``csrc/cg_flat_decode.cu`` in which thread 0 of each CTA
reads ``clock64()`` after every CTA or cluster barrier of the scan's tile
loop and sums the cycles between barriers per phase (prep; A; the composed
maps' exchange, on a cluster only; B; C; the outputs' exchange); CTA 0
writes its sums to a device array that the script reads back.  The copy is built into its own library (never the
package's) and run on seeded random residuals at [1,1024,1024] (a
cluster of 8 CTAs), [17,256,1024] (1024 columns, one CTA a frame: 17
frames do not fit clusters of 8 on 132 SMs), [1,4096,256] and
[1,16384,64]; its output is checked against the package's K4.  One JSON line per shape: the CUDA-event time of the copy,
and the cycles per row of each phase (CTA 0's SM clock, so a sum over
phases is a row's time in cycles).  The stamps cost a few instructions per
barrier, so the copy is a little slower than K4 itself.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import numpy as np
import torch

from fpv_tpu_torch.models import predictors
from fpv_tpu_torch.utils import kernels

SHAPES = ((1, 1024, 1024), (17, 256, 1024), (1, 4096, 256), (1, 16384, 64))
PHASES = ("prep", "A", "compose", "B", "C", "out")
_LOOP = "  while (c < nchunks) {"
_LOOP_END = "__device__ __forceinline__ uint32_t step("


def stamped_source(src: str) -> tuple[str, int]:
    """``src`` with a clock stamp after each barrier of the scan's tile loop
    and an entry ``k4_prof_read(host)`` that copies CTA 0's sums out ->
    (the source, the number of stamped barriers)."""
    start, end = src.index(_LOOP), src.index(_LOOP_END)
    count = [0]

    def stamp(m):
        count[0] += 1
        return (m.group(0) + " if (tid == 0) { long long t_ = clock64(); "
                f"acc_[{count[0] - 1}] += t_ - last_; last_ = t_; }}")

    body = re.sub(
        r"__syncthreads\(\);|this_cluster\(\)\.sync\(\);|"
        r"frame_sync<kCluster>\(\);", stamp, src[start:end])
    body = body.replace(
        "    c = cn;\n    t0 = tn;\n  }\n}",
        "    c = cn;\n    t0 = tn;\n  }\n  if (tid == 0 && blockIdx.x == 0)\n"
        "    for (int i = 0; i < 8; ++i) g_prof[i] = acc_[i];\n}")
    out = (src[:start]
           + "  long long acc_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
           "  long long last_ = clock64();\n" + body + src[end:])
    out = out.replace("namespace {", "__device__ long long g_prof[8];\n"
                      "namespace {", 1)
    out += ('\nextern "C" int k4_prof_read(void* host) {\n'
            "  return (int)cudaMemcpyFromSymbol(host, g_prof, "
            "sizeof(long long) * 8);\n}\n")
    return out, count[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_cg_flat: torch.cuda.is_available() is false")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    src, nstamps = stamped_source(
        (kernels.CSRC / "cg_flat_decode.cu").read_text())
    if nstamps != len(PHASES):
        raise AssertionError(f"{nstamps} barriers in the tile loop, expected "
                             f"{len(PHASES)}: update PHASES")
    out_dir = kernels.BUILD_DIR / "profile_cg_flat"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "cg_flat_stamped.cu", out_dir / "libcg_flat_stamped.so"
    cu.write_text(src)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.fpv1_cg_flat_decode
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    dev = torch.device("cuda")
    for shape in SHAPES:
        rng = np.random.default_rng(sum(shape))
        res = torch.from_numpy(
            rng.integers(0, 256, shape, np.int64).astype(np.uint8)).to(dev)
        out = torch.empty_like(res)
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(args.reps):  # the last run's events and stamps count
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            if fn(res.data_ptr(), out.data_ptr(), *shape, stream):
                raise RuntimeError("the stamped K4 did not launch")
            e1.record()
            torch.cuda.synchronize()
        if not torch.equal(out, predictors.cg_flat_decode(res)):
            raise AssertionError(f"the stamped K4 differs from K4 at {shape}")
        sums = (ctypes.c_longlong * 8)()
        if lib.k4_prof_read(sums):
            raise RuntimeError("could not read the stamps")
        rows = shape[1]
        cycles = {p: sums[i] / rows for i, p in enumerate(PHASES)}
        print(json.dumps(dict(
            shape=list(shape), ms=e0.elapsed_time(e1),
            seg_len=predictors.segment_length(shape[2]),
            cycles_per_row=cycles,
            cycles_per_row_total=sum(cycles.values()))), flush=True)


if __name__ == "__main__":
    main()

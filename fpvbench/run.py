"""Run one cell of the benchmark once and print its result line.

    python3 -m fpvbench.run --workload cam12_1mp.ingest --seed 7 \
        --seconds 20 --trace 0

Set-up (frames from the seed, the files the cell reads, a warm-up of every
shape the cell uses) counts as ``setup_s`` from the start of this module.
Then the window runs for ``--seconds``, then the check.  The last line of
standard output is one JSON object; the numbers the check compared, each
with its limit, are the last lines of standard error and the result's
last key.  Exits 2 without a result when the cell's cards are missing,
and 3 when a module of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed place inside the checkout; the
# codec's own kernel library is built into build/fpv_tpu_torch/
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(REPO / "build" / sub)
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None,
                   help="plant a fault under the timed path (the check's "
                   "own tests and controls: lossy, flip, half, stale)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from fpvbench import harness, imports

    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        harness.log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                    f"found {torch.cuda.device_count()}")
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", args.fault, T0,
                              bench)
    bad = imports.forbidden(list(sys.modules))
    if bad:
        harness.log(f"the run loaded {', '.join(bad)}: no result")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

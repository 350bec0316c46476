"""Build, load and count the package's hand-written CUDA kernels.

The sources in ``fpv_tpu_torch/csrc/`` are compiled with nvcc into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), at first use, into ``build/fpv_tpu_torch/`` beside the
package.  The library file name carries a hash of the sources and flags,
so an edited source rebuilds and an unchanged one loads the existing
build.  Nothing is built or loaded when a module is imported: the CPU
paths never touch this module's loader.

This library is the port's cold-start cache, the counterpart of the JAX
package's serialized executables (``fpv_tpu/utils/aotcache.py``): a
process whose sources are already built loads the library (no nvcc) and
pays only the CUDA context and the first launches, which
``fpvt_codec.warmup_stream`` takes ahead of traffic.

``LAUNCHES`` counts kernel launches per wrapper name; each wrapper adds
one where it launches its kernel and nowhere else.  The build and the
counts are safe to reach from several threads at once (the serving hubs'
workers): one thread builds and loads, the others wait for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "fpv_tpu_torch"
SOURCES = ("rans_encode.cu", "rans_decode.cu", "rans_decode_variants.cu",
           "cg2d_decode.cu", "cg_flat_decode.cu")
HEADERS = ("rans_decode_step.cuh",)  # included by the sources; hashed too
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {"rans_encode_chain": 0, "rans_encode_place": 0,
            "rans_decode": 0, "rans_decode_variant": 0, "cg2d_decode": 0,
            "cg_flat_decode": 0}

_BUILD_LOCK = threading.RLock()  # the build and the load of the library
_COUNT_LOCK = threading.Lock()  # LAUNCHES updates
_LIB: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (every entry returns cudaError_t as int)
_SIGNATURES = {
    # descs, ndesc, nctas, stream
    "fpvt_rans_encode_chain": (_P, _I, _I, _P),
    # descs, ndesc, nctas, nsub, stream
    "fpvt_rans_encode_chain_nsub": (_P, _I, _I, _I, _P),
    # descs, ndesc, ngroups, payload, stream
    "fpvt_rans_encode_place": (_P, _I, _I, _P, _P),
    # descs, ndesc, nctas, threads, stream
    "fpvt_rans_decode": (_P, _I, _I, _I, _P),
    # descs, ndesc, nctas, threads, stub_tables, stub_window, classes,
    # prob_bits, two_table, nsub, ctx, stream
    "fpvt_rans_decode_variant": (_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _P),
    # res, out, b, h, w, stream
    "fpvt_cg2d_decode": (_P, _P, _I, _I, _I, _P),
    # res, out, b, rows, x, stream
    "fpv1_cg_flat_decode": (_P, _P, _I, _I, _I, _P),
}


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """Add one launch of ``name`` (read-modify-write under a lock)."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libfpvt_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise with the output of the first that
    fails, else return their outputs joined."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{out}")
    return "".join(outs)


def build() -> pathlib.Path:
    """Compile the kernels (if this exact source set is not built yet): one
    nvcc per source, all started together, then one link.  The compiler's
    report (ptxas registers, shared memory, spills per kernel) is kept
    beside the library as ``<library>.log``."""
    out = library_path()
    with _BUILD_LOCK:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
            nvcc = _nvcc()
            report = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o,
                                str(CSRC / s)]
                               for s, o in zip(SOURCES, objs)])
            out.with_suffix(".log").write_text(report)
            lib = os.path.join(tmp, out.name)
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
            os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The kernels' library, built (:func:`build`) and loaded on first
    use, once per process."""
    global _LIB
    with _BUILD_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def launch(name: str, fn_name: str, device: torch.device, *args) -> None:
    """Call C entry ``fn_name`` on ``device``'s current stream; raise on a
    launch error and count the launch under ``name``."""
    fn = getattr(library(), fn_name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    count_launch(name)


def check_cuda(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")

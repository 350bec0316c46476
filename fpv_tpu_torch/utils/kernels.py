"""Build, load and count the package's hand-written CUDA kernels.

The sources in ``fpv_tpu_torch/csrc/`` are compiled with nvcc into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), at first use, into ``build/fpv_tpu_torch/`` beside the
package.  The library file name carries a hash of the sources and flags,
so an edited source rebuilds and an unchanged one loads the existing
build.  Nothing is built or loaded when a module is imported: the CPU
paths never touch this module's loader.

``LAUNCHES`` counts kernel launches per wrapper name; each wrapper adds
one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "fpv_tpu_torch"
SOURCES = ("rans_encode.cu", "rans_decode.cu", "cg2d_decode.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES = {"rans_encode": 0, "rans_decode": 0, "cg2d_decode": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (every entry returns cudaError_t as int)
_SIGNATURES = {
    # syms, lens, fc, nidx, nblocks, chunk_len, prob_bits, ctx_mode,
    # states, words, counts, stream
    "fpvt_rans_encode": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # counts, starts, states, lens, table, payload, total_words, nblocks,
    # chunk_len, prob_bits, ctx_mode, out, ok, stream
    "fpvt_rans_decode": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P, _P,
                         _P),
    # res, out, b, h, w, stream
    "fpvt_cg2d_decode": (_P, _P, _I, _I, _I, _P),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libfpvt_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels (if this exact source set is not built yet)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, fn_name: str, device: torch.device, *args) -> None:
    """Call C entry ``fn_name`` on ``device``'s current stream; raise on a
    launch error and count the launch under ``name``."""
    fn = getattr(library(), fn_name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def check_cuda(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")

"""Brotli bridge of the FPV1 profile: ctypes onto the system libbrotli.

The reference format's entropy layer is libbrotli at quality 1, the
default window and mode (fusion_power_video.cc:166-169, 653-654).  Byte
identity with the reference is only reachable by calling the same
deterministic encoder, so this module binds ``libbrotlienc.so.1`` and
``libbrotlidec.so.1`` (loaded at first use, never at import).  ctypes
releases the interpreter lock for the length of each foreign call, so
frames compress and decompress in parallel on a thread pool.

Decompression mirrors ``BrotliDecompress`` (fusion_power_video.cc:186-214):
it decodes ONE brotli stream out of a buffer that may hold two
concatenated streams and reports where that stream ended.  Every stream is
decoded straight into a caller's buffer of the size the caller expects
(``decompress_into``) or, where the size is unknown, into one that grows
up to a cap (``decompress_stream``), and one that would grow past it
raises ``ValueError`` (a brotli bomb cannot allocate beyond the plane it
claims to be).  ``compress_into`` writes a stream straight into a
caller's buffer (the Arrow columns).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

import numpy as np

QUALITY = 1  # FPV_BROTLI_QUALITY (fusion_power_video.cc:169)
DEFAULT_WINDOW = 22  # BROTLI_DEFAULT_WINDOW
MODE_GENERIC = 0  # BROTLI_DEFAULT_MODE
# default cap of decompress_stream: the format's image-size guard
# (fusion_power_video.cc:164)
MAX_STREAM_SIZE = 1_000_000_000

# BrotliDecoderResult values (the public C API)
_RESULT_SUCCESS = 1
_RESULT_NEEDS_MORE_OUTPUT = 3

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_SZ = ctypes.c_size_t
_PSZ = ctypes.POINTER(ctypes.c_size_t)


def _load(stem: str) -> ctypes.CDLL:
    for name in (f"lib{stem}.so.1", f"lib{stem}.so",
                 ctypes.util.find_library(stem)):
        if not name:
            continue
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise OSError(f"cannot locate lib{stem}: the FPV1 profile needs the "
                  "system libbrotli")


class _Brotli:
    """The few entry points of the stable brotli C API the format uses."""

    def __init__(self) -> None:
        enc = _load("brotlienc")
        dec = _load("brotlidec")
        self.compress = enc.BrotliEncoderCompress
        self.compress.restype = ctypes.c_int
        self.compress.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  _SZ, _P, _PSZ, _P]
        self.max_size = enc.BrotliEncoderMaxCompressedSize
        self.max_size.restype = _SZ
        self.max_size.argtypes = [_SZ]
        self.create = dec.BrotliDecoderCreateInstance
        self.create.restype = _P
        self.create.argtypes = [_P, _P, _P]
        self.destroy = dec.BrotliDecoderDestroyInstance
        self.destroy.restype = None
        self.destroy.argtypes = [_P]
        self.stream = dec.BrotliDecoderDecompressStream
        self.stream.restype = ctypes.c_int
        self.stream.argtypes = [_P, _PSZ, _PP, _PSZ, _PP, _P]


_LIB: _Brotli | None = None
_LOCK = threading.Lock()


def _lib() -> _Brotli:
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _Brotli()
        return _LIB


def available() -> bool:
    """True when the system libbrotli loads."""
    try:
        _lib()
    except OSError:
        return False
    return True


def max_compressed_size(n: int) -> int:
    """``BrotliEncoderMaxCompressedSize`` (fusion_power_video.cc:355-361):
    the largest stream :func:`compress` can make of ``n`` bytes (0 when
    ``n`` is too large to bound)."""
    return int(_lib().max_size(int(n)))


def _compress_to(src: np.ndarray, out: np.ndarray, quality: int) -> int:
    """One ``BrotliEncoderCompress`` call of the uint8 array ``src`` into
    the writable uint8 array ``out`` -> the stream's length.  With ``out``
    at least :func:`max_compressed_size` long the bytes do not depend on
    its length."""
    n = src.size
    if not n:
        src = np.zeros(1, np.uint8)  # a valid pointer for the empty input
    size = _SZ(out.size)
    ok = _lib().compress(quality, DEFAULT_WINDOW, MODE_GENERIC, n,
                         src.ctypes.data, ctypes.byref(size), out.ctypes.data)
    if not ok:
        if out.size < max_compressed_size(n):
            raise ValueError("destination smaller than the compressed stream")
        raise RuntimeError("brotli compression failed")
    return size.value


def compress(data, quality: int = QUALITY) -> bytes:
    """Brotli-compress ``data`` (any buffer) exactly as the reference does:
    one ``BrotliEncoderCompress`` call, window 22, generic mode."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max_compressed_size(src.size) or 64, np.uint8)
    return out[: _compress_to(src, out, quality)].tobytes()


def compress_into(data, dest, quality: int = QUALITY) -> int:
    """Compress ``data`` (any buffer) straight into the writable buffer
    ``dest`` -> the stream's length; the bytes equal :func:`compress`'s.
    ``dest`` should hold :func:`max_compressed_size` bytes: a shorter one
    that the stream does not fit raises ``ValueError``."""
    out = np.frombuffer(dest, np.uint8)
    if not out.flags.writeable:
        raise ValueError("dest must be a writable buffer")
    return _compress_to(np.frombuffer(data, np.uint8), out, quality)


def decompress_into(data, pos: int, dest: np.ndarray) -> tuple[int, int]:
    """Decode the one brotli stream of ``data`` (any buffer) that starts at
    ``pos`` into the contiguous uint8 array ``dest`` -> (bytes written,
    end position of the stream).  Raises ``ValueError`` when the stream is
    corrupt or truncated, or when it decodes to more than ``dest`` holds."""
    lib = _lib()
    src = np.frombuffer(data, np.uint8)
    if pos > src.size:
        raise ValueError("out of bounds")
    if not dest.flags.c_contiguous or dest.dtype != np.uint8:
        raise ValueError("dest must be a contiguous uint8 array")
    state = lib.create(None, None, None)
    if not state:
        raise RuntimeError("couldn't init brotli decoder")
    try:
        avail_in = _SZ(src.size - pos)
        next_in = _P(src.ctypes.data + pos)
        avail_out = _SZ(dest.size)
        next_out = _P(dest.ctypes.data)
        result = lib.stream(state, ctypes.byref(avail_in),
                            ctypes.byref(next_in), ctypes.byref(avail_out),
                            ctypes.byref(next_out), None)
        written = dest.size - avail_out.value
        if result == _RESULT_NEEDS_MORE_OUTPUT:
            # dest is full: the stream is too long unless it ends here
            probe = (ctypes.c_uint8 * 1)()
            avail_probe = _SZ(1)
            next_probe = _P(ctypes.addressof(probe))
            result = lib.stream(state, ctypes.byref(avail_in),
                                ctypes.byref(next_in),
                                ctypes.byref(avail_probe),
                                ctypes.byref(next_probe), None)
            if avail_probe.value == 0:
                raise ValueError("decompressed stream larger than expected")
        if result != _RESULT_SUCCESS:
            raise ValueError("brotli decompression failed")
        return written, src.size - avail_in.value
    finally:
        lib.destroy(state)


def decompress_stream(data, pos: int = 0,
                      max_size: int = MAX_STREAM_SIZE) -> tuple[bytes, int]:
    """Decode the one brotli stream of ``data`` (any buffer) that starts at
    ``pos`` -> (decoded bytes, end position of the stream), for callers
    that do not know its decoded size.  The output grows as the stream
    needs, up to ``max_size`` bytes: a stream that decodes to more raises
    ``ValueError``, as a corrupt or truncated one does."""
    lib = _lib()
    src = np.frombuffer(data, np.uint8)
    if pos > src.size:
        raise ValueError("out of bounds")
    state = lib.create(None, None, None)
    if not state:
        raise RuntimeError("couldn't init brotli decoder")
    try:
        avail_in = _SZ(src.size - pos)
        next_in = _P(src.ctypes.data + pos)
        # one byte past the cap, so a stream longer than it shows itself
        limit = max_size + 1
        out = np.empty(min(limit, max(1 << 16, 4 * (src.size - pos))),
                       np.uint8)
        written = 0
        while True:
            avail_out = _SZ(out.size - written)
            next_out = _P(out.ctypes.data + written)
            result = lib.stream(state, ctypes.byref(avail_in),
                                ctypes.byref(next_in), ctypes.byref(avail_out),
                                ctypes.byref(next_out), None)
            written = out.size - avail_out.value
            if written > max_size:
                raise ValueError("decompressed stream larger than expected")
            if result != _RESULT_NEEDS_MORE_OUTPUT:
                break
            grown = np.empty(min(limit, 2 * out.size), np.uint8)
            grown[:written] = out[:written]
            out = grown
        if result != _RESULT_SUCCESS:
            raise ValueError("brotli decompression failed")
        return out[:written].tobytes(), src.size - avail_in.value
    finally:
        lib.destroy(state)

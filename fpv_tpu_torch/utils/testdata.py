"""Deterministic synthetic corpora for tests and the chip smoke run.

Same generators, seeds and values as ``fpv_tpu/utils/testdata.py``: a
bright drifting blob ("plasma") over a static background with sensor
noise, incompressible noise, ramps and constant frames, and raw capture
bytes.
"""

from __future__ import annotations

import numpy as np


def plasma_frames(
    n: int,
    ysize: int,
    xsize: int,
    bits: int = 16,
    seed: int = 42,
    noise: int = 6,
) -> np.ndarray:
    """[N, H, W] uint16 frames: static background + moving Gaussian blob + noise.

    Values occupy the low ``bits`` bits (right-aligned), matching raw camera
    output that the reference left-aligns with ``shift = 16 - bits``.
    """
    rng = np.random.default_rng(seed)
    maxval = (1 << bits) - 1
    yy, xx = np.mgrid[0:ysize, 0:xsize].astype(np.float32)
    background = (
        (np.sin(xx / 17.0) + np.cos(yy / 23.0) + 2.0) * 0.12 * maxval
    ).astype(np.float32)
    frames = np.empty((n, ysize, xsize), dtype=np.uint16)
    for i in range(n):
        cx = xsize * (0.3 + 0.4 * np.sin(i * 0.3))
        cy = ysize * (0.5 + 0.3 * np.cos(i * 0.2))
        sigma = max(xsize, ysize) / 6.0
        blob = 0.6 * maxval * np.exp(
            -((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma**2)
        )
        img = background + blob
        if noise:
            img = img + rng.integers(0, noise, size=img.shape)
        frames[i] = np.clip(img, 0, maxval).astype(np.uint16)
    return frames


def noise_frames(
    n: int, ysize: int, xsize: int, bits: int = 16, seed: int = 7
) -> np.ndarray:
    """Incompressible uniform noise."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, size=(n, ysize, xsize), dtype=np.uint16)


def ramp_frames(n: int, ysize: int, xsize: int) -> np.ndarray:
    """Deterministic diagonal ramps (like columnar_batch_decoder_test.cc:34-47)."""
    yy, xx = np.mgrid[0:ysize, 0:xsize]
    base = (xx * 7 + yy * 13).astype(np.uint16)
    return np.stack([(base + 31 * i).astype(np.uint16) for i in range(n)])


def constant_frames(n: int, ysize: int, xsize: int, value: int = 0x1234) -> np.ndarray:
    """Degenerate constant frames (exercise zero-entropy decision paths)."""
    return np.full((n, ysize, xsize), value, dtype=np.uint16)


def to_raw_bytes(frames: np.ndarray, shift: int = 0, big_endian: bool = False) -> bytes:
    """Frames (right-aligned values) -> raw capture bytes as a camera would
    emit them (values NOT pre-shifted; ``shift`` is the encoder's)."""
    frames = np.asarray(frames, dtype=np.uint16)
    dt = np.dtype(">u2" if big_endian else "<u2")
    return frames.astype(dt).tobytes()


def raw_to_frames(
    raw: bytes, ysize: int, xsize: int, big_endian: bool = False
) -> np.ndarray:
    dt = np.dtype(">u2" if big_endian else "<u2")
    arr = np.frombuffer(raw, dtype=dt).astype(np.uint16)
    n = arr.size // (ysize * xsize)
    return arr[: n * ysize * xsize].reshape(n, ysize, xsize)

"""K4's plain version (the FPV1 flat-CG inverse as a row-wise scan of byte
maps) against the JAX package's scan, exactly.

``cg_flat_decode_ref`` follows the kernel's schedule: chunks of W pixels,
segments of ``seg_len`` pixels, a 256-entry table per segment (phase A),
the segments' start values (phase B) and a walk of each segment (phase C).
Each case holds it to ``fpv_tpu.models.predictors.cg_decode_np`` (the
pixel-by-pixel oracle) and ``cg_decode`` (the native host scan where it is
built), at the kernel's segment length and at others.
"""

import numpy as np
import pytest
import torch

from fpv_tpu.models import predictors as jpred
from fpv_tpu_torch.models import predictors as tpred
from fpv_tpu_torch.utils import testdata

SHAPES = [(1, 1, 1), (3, 1, 9), (2, 2, 7), (3, 9, 1), (2, 6, 5), (1, 17, 23),
          (1, 40, 63), (2, 65, 64), (1, 33, 100)]
# 1 and 3: many segments; 8 and 32: the kernel's lengths at 64 and 1024
# columns; 101: one segment longer than any row here
SEG_LENS = [None, 1, 3, 8, 32, 101]


def _jax_decode(res: np.ndarray) -> np.ndarray:
    return np.stack([jpred.cg_decode_np(p) for p in res])


def _smooth(shape, rng) -> np.ndarray:
    """A smooth plane (a ramp plus small noise): small d, few reflections."""
    b, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * 3 + xx * 2)[None] + rng.integers(0, 3, (b, h, w))
    return (base % 256).astype(np.uint8)


@pytest.mark.parametrize("seg_len", SEG_LENS, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_scan_ref_matches_jax_scan(shape, seg_len):
    """Random residuals, and the flat CG residual of a smooth plane (which
    must come back as the plane)."""
    rng = np.random.default_rng(sum(shape) + (seg_len or 0))
    noise = rng.integers(0, 256, shape, dtype=np.uint8)
    got = tpred.cg_flat_decode_ref(torch.from_numpy(noise), seg_len)
    np.testing.assert_array_equal(got.numpy(), _jax_decode(noise))
    plane = _smooth(shape, rng)
    res = np.stack([jpred.cg_encode_np(p) for p in plane])
    got = tpred.cg_flat_decode_ref(torch.from_numpy(res), seg_len)
    np.testing.assert_array_equal(got.numpy(), plane)


@pytest.mark.parametrize("seg_len", [None, 3, 32], ids=str)
def test_scan_ref_plasma_residual(seg_len):
    """The flat CG residual of a 128 x 256 plasma high plane, as FPV1 codes
    it; equal to the native host scan ``cg_decode`` and the input."""
    frame = testdata.plasma_frames(1, 128, 256, bits=12, seed=4)[0]
    high = (frame >> 4).astype(np.uint8)
    res = np.array(jpred.cg_encode(high))
    got = tpred.cg_flat_decode_ref(torch.from_numpy(res[None]), seg_len)
    np.testing.assert_array_equal(got[0].numpy(), jpred.cg_decode(res))
    np.testing.assert_array_equal(got[0].numpy(), high)


@pytest.mark.parametrize("seg_len", [None, 1, 3, 8], ids=str)
def test_scan_ref_grown_rows(seg_len):
    """A grown preview buffer (56 entries at stride 7, inverted as 8 rows):
    equal to the oracle, and its leading 49 entries equal the inverse of
    the 7 x 7 preview alone (no row depends on a later one)."""
    rng = np.random.default_rng(3)
    ext = rng.integers(0, 256, 56, dtype=np.uint8)
    full = tpred.cg_flat_decode_ref(torch.from_numpy(ext.reshape(1, 8, 7)),
                                    seg_len)
    np.testing.assert_array_equal(full[0].numpy(),
                                  jpred.cg_decode_np(ext.reshape(8, 7)))
    head = tpred.cg_flat_decode_ref(
        torch.from_numpy(ext[:49].reshape(1, 7, 7)), seg_len)
    np.testing.assert_array_equal(full.reshape(-1)[:49].numpy(),
                                  head.reshape(-1).numpy())


def test_segment_length_rule():
    """ceil(sqrt(min(W, 1024))) rounded up to a multiple of 4: a tile never
    has more than 32 segments, and a segment fits phase C's 32 steps."""
    for w in list(range(1, 2100)) + [40000, 65536]:
        seg = tpred.segment_length(w)
        tile = min(w, tpred.TILE)
        assert seg % 4 == 0 and seg * seg >= tile
        assert seg == 4 or (seg - 4) ** 2 < tile
        assert -(-tile // seg) <= 32 and seg <= 32


def test_branch_free_form_equals_clamped_gradient():
    """The scan's form of one pixel's map over all 256^3 (n, w, nw):
    d >= 0 ? max(w, min(w + d, n)) : min(w, max(w + d, n)) equals
    ``clamped_gradient_np``, and so does w + clamp(n - w, min(0, d),
    max(0, d)), the plain version's form."""
    w = np.arange(256, dtype=np.int32)[None, :, None]
    nw = np.arange(256, dtype=np.int32)[None, None, :]
    for n0 in range(0, 256, 32):
        n = np.arange(n0, n0 + 32, dtype=np.int32)[:, None, None]
        d = n - nw
        med = np.where(d >= 0, np.maximum(w, np.minimum(w + d, n)),
                       np.minimum(w, np.maximum(w + d, n)))
        want = jpred.clamped_gradient_np(
            *np.broadcast_arrays(n.astype(np.uint8), w.astype(np.uint8),
                                 nw.astype(np.uint8)))
        np.testing.assert_array_equal(med, want)
        clamp = w + np.clip(n - w, np.minimum(d, 0), np.maximum(d, 0))
        np.testing.assert_array_equal(clamp, want)


def test_reflected_form_equals_clamped_gradient():
    """The kernel steps a d < 0 pixel on 255 - w: for every (n, w, nw, r)
    with d < 0 (r sampled), max(u + R, min(u + DR, NR)) & 255 with
    R = 256 - r, DR = 256 - r - d, NR = 511 - n - r and u = 255 - w is
    255 - (r + CG) mod 256; for d >= 0, with R = r, DR = d + r, NR = n + r
    and u = w, it is (r + CG) mod 256.  Every value stays in [0, 766]."""
    w = np.arange(256, dtype=np.int32)[None, :, None]
    nw = np.arange(256, dtype=np.int32)[None, None, :]
    for n0 in range(0, 256, 64):
        n = np.arange(n0, n0 + 64, dtype=np.int32)[:, None, None]
        d = n - nw
        neg = d < 0
        cg = jpred.clamped_gradient_np(
            *np.broadcast_arrays(n.astype(np.uint8), w.astype(np.uint8),
                                 nw.astype(np.uint8))).astype(np.int32)
        u = np.where(neg, 255 - w, w)
        for r in (0, 77, 255):
            big_r = np.where(neg, 256 - r, r)
            dr = np.where(neg, 256 - r - d, d + r)
            nr = np.where(neg, 511 - n - r, n + r)
            assert dr.min() >= 0 and nr.max() <= 766
            assert (u + dr).max() <= 766
            got = np.maximum(u + big_r, np.minimum(u + dr, nr)) & 255
            np.testing.assert_array_equal(np.where(neg, 255 - got, got),
                                          (r + cg) & 255)


def test_profile_tool_stamps_every_phase():
    """``utils/profile_cg_flat`` (run on the card) finds the scan's tile
    loop in K4's source and stamps each of its barriers once."""
    from fpv_tpu_torch.utils import kernels, profile_cg_flat

    src, n = profile_cg_flat.stamped_source(
        (kernels.CSRC / "cg_flat_decode.cu").read_text())
    assert n == len(profile_cg_flat.PHASES)
    assert src.count("clock64()") == n + 1 and "k4_prof_read" in src

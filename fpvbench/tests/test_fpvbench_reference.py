"""The plain reference reader against files the codec writes on the CPU,
and its predictors against their forward definitions."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fpvbench import frames as framegen
from fpvbench.reference import fpvt as ref


def _frames(n, h, w, bits, seed=3):
    return framegen.to_host(framegen.plasma(n, h, w, bits, 6, seed, "cpu"))


def _written(frames, shift, narrow=True, fpb=4, chunk_log2=8):
    """A file the codec writes on the CPU: the one-shot writer (its narrow
    policy for small files) or the 1024-lane writer."""
    import fpv_tpu_torch

    if narrow:
        return fpv_tpu_torch.encode_file_fpvt(
            frames, shift=shift, frames_per_batch=fpb,
            chunk_log2=chunk_log2, device="cpu")
    n, h, w = frames.shape
    wri = fpv_tpu_torch.FpvtWriter(w, h, shift, False, fpb, chunk_log2,
                                   device="cpu", narrow=False)
    parts = [wri.init(frames[0])]
    parts += [wri.encode_batch(frames[s : s + fpb]) for s in range(1, n, fpb)]
    return b"".join(parts + [wri.finish()])


@pytest.mark.parametrize("bits,shift,narrow", [
    (12, 4, True), (16, 0, True), (12, 4, False), (16, 0, False)])
def test_reference_decodes_codec_file(bits, shift, narrow):
    frames = _frames(9, 32, 64, bits)
    data = _written(frames, shift, narrow)
    f = ref.parse(data)
    dec = ref.decode(f, "cpu")
    want = ref.left_aligned(torch.from_numpy(frames.astype(np.int32)), shift)
    if narrow:
        assert f.delta_is_frame0 and dec.frames.shape == want.shape
    else:
        # the explicit delta frame is no frame of the file
        assert not f.delta_is_frame0
        want = want[1:]
    assert dec.faults == 0
    assert torch.equal(dec.frames, want)
    first = 1 if f.delta_is_frame0 else 0
    pv = ref.box_preview((dec.frames[first:] >> 8).to(torch.uint8))
    assert torch.equal(dec.previews, pv)
    lanes = {s["lanes"] for s in ref.stream_geometry(f)}
    assert (1024 in lanes) == (not narrow)


def test_corrupt_payload_is_caught():
    frames = _frames(9, 32, 64, 12)
    data = _written(frames, 4, narrow=False)
    want = ref.left_aligned(torch.from_numpy(frames[1:].astype(np.int32)), 4)
    for at in range(len(data) // 4, len(data) - 64, len(data) // 8):
        bad = bytearray(data)
        bad[at] ^= 0x10
        try:
            dec = ref.decode(ref.parse(bytes(bad)), "cpu")
        except ref.FormatError:
            continue  # refused: caught
        assert dec.faults > 0 or not torch.equal(dec.frames, want), at


def test_truncated_file_is_refused():
    data = _written(_frames(5, 32, 64, 12), 4)
    with pytest.raises(ref.FormatError):
        ref.parse(data[:-9])
    with pytest.raises(ref.FormatError):
        ref.parse(data[: len(data) // 2])


def _up_forward(x):
    r = x.astype(np.int64).copy()
    r[:, 1:] = x[:, 1:].astype(np.int64) - x[:, :-1]
    return (r & 0xFF).astype(np.uint8)


def _cg2d_forward(x):
    x = x.astype(np.int64)
    r = x.copy()
    r[:, 1:, 0] = x[:, 1:, 0] - x[:, :-1, 0]
    n, w, nw = x[:, :-1, 1:], x[:, 1:, :-1], x[:, :-1, :-1]
    pred = np.clip(n + w - nw, np.minimum(n, w), np.maximum(n, w))
    r[:, 1:, 1:] = x[:, 1:, 1:] - pred
    return (r & 0xFF).astype(np.uint8)


@pytest.mark.parametrize("shape", [(2, 7, 5), (1, 16, 48), (3, 33, 9)])
def test_spatial_inverses(shape):
    x = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    for fwd, mode in ((_up_forward, ref.SPATIAL_UP),
                      (_cg2d_forward, ref.SPATIAL_CG2D)):
        res = torch.from_numpy(fwd(x))
        got = ref.spatial_inverse(res, np.full(shape[0], mode))
        assert np.array_equal(got.numpy(), x)
    same = ref.spatial_inverse(torch.from_numpy(x), np.zeros(shape[0], int))
    assert np.array_equal(same.numpy(), x)


def test_box_preview():
    hi = torch.arange(2 * 8 * 8, dtype=torch.int64).reshape(2, 8, 8) % 256
    pv = ref.box_preview(hi.to(torch.uint8))
    want = hi.reshape(2, 2, 4, 2, 4).sum((2, 4)) // 16 & 0xFE
    assert torch.equal(pv, want.to(torch.uint8))

"""The port's profile transcoder against the JAX package's, on the CPU.

Mirrors tests/test_transcode.py case by case; each case also holds the
port's output bytes to ``fpv_tpu.api.transcode``'s for the same input
and settings, exactly.  Added: FPV1 -> FPVT -> FPV1 returns the input
file, and the fused 1024-lane geometry (the narrow bound lowered to 0 on
both sides; the JAX side runs its pallas engine there).
"""

import subprocess
import sys

import numpy as np
import pytest

import fpv_tpu_torch
from fpv_tpu.api import transcode as jt
from fpv_tpu.api.decoder import decode_file
from fpv_tpu.api.encoder import encode_file
from fpv_tpu.api.fpvt_codec import decode_file_fpvt, encode_file_fpvt
from fpv_tpu.format.fpvt import Header
from fpv_tpu_torch.api import transcode as tt
from fpv_tpu_torch.entropy import plane_codec as tpc
from fpv_tpu_torch.utils import testdata

from conftest import REPO, ref_encode, requires_reference
from test_torch_cli import run_port_cli

CPU = dict(device="cpu")


def _to_fpvt(data, **kw):
    """The port's and JAX's FPV1 -> FPVT of ``data``: equal bytes."""
    ours = tt.transcode_to_fpvt(data, **kw, **CPU)
    assert ours == jt.transcode_to_fpvt(data, **kw)
    return ours


def _to_fpv1(data, **kw):
    """The port's and JAX's FPVT -> FPV1 of ``data``: equal bytes."""
    ours = tt.transcode_to_fpv1(data, **kw, **CPU)
    assert ours == jt.transcode_to_fpv1(data, **kw)
    return ours


def test_fpv1_to_fpvt_roundtrip():
    frames = testdata.plasma_frames(5, 24, 40, bits=12)  # raw 12-bit
    fpv1 = encode_file(frames, shift=4)
    out = _to_fpvt(fpv1, shift=4, frames_per_batch=3)
    assert tt.sniff_profile(out) == "fpvt"
    np.testing.assert_array_equal(decode_file_fpvt(out), decode_file(fpv1))
    np.testing.assert_array_equal(
        fpv_tpu_torch.decode_file_fpvt(out, **CPU), frames << 4)
    # the reference CLI layout (frame 0 == delta) earns the stored-once flag
    assert Header.parse(out).delta_is_frame0
    assert Header.parse(out).shift == 4


def test_fpv1_to_fpvt_distinct_delta():
    frames = testdata.plasma_frames(4, 16, 24)
    delta = testdata.plasma_frames(1, 16, 24, seed=9)[0]
    fpv1 = encode_file(frames, delta_frame=delta)
    out = _to_fpvt(fpv1, frames_per_batch=2)
    assert not Header.parse(out).delta_is_frame0
    np.testing.assert_array_equal(decode_file_fpvt(out), decode_file(fpv1))


def test_fpv1_to_fpvt_wrong_shift_rejected():
    # left-aligned samples with nonzero low bits are not representable at
    # shift=4; the transcoder must refuse rather than silently truncate
    frames = testdata.plasma_frames(2, 16, 16, bits=16)
    frames |= 1
    fpv1 = encode_file(frames, shift=0)
    with pytest.raises(ValueError, match="not representable"):
        tt.transcode_to_fpvt(fpv1, shift=4, **CPU)
    with pytest.raises(ValueError, match="not representable"):
        jt.transcode_to_fpvt(fpv1, shift=4)


def test_fpvt_to_fpv1_roundtrip():
    frames = testdata.plasma_frames(5, 24, 32, bits=12)
    fpvt = encode_file_fpvt(frames, shift=4, frames_per_batch=2)
    out = _to_fpv1(fpvt)
    assert tt.sniff_profile(out) == "fpv1"
    np.testing.assert_array_equal(decode_file(out), decode_file_fpvt(fpvt))


def test_fpvt_to_fpv1_drops_timestamps_with_warning():
    frames = testdata.plasma_frames(3, 16, 16)
    ts = np.arange(3, dtype=np.int64) * 1000
    fpvt = encode_file_fpvt(frames, frames_per_batch=2, timestamps=ts)
    with pytest.warns(UserWarning, match="timestamp"):
        out = tt.transcode_to_fpv1(fpvt, **CPU)
    with pytest.warns(UserWarning, match="timestamp"):
        assert out == jt.transcode_to_fpv1(fpvt)
    np.testing.assert_array_equal(decode_file(out), decode_file_fpvt(fpvt))


def test_fpv1_to_fpvt_big_endian_roundtrip():
    # big-endian raw contract: the FPVT header records it, and the final
    # FPV1 re-encode reproduces the same decoded pixels
    frames = testdata.plasma_frames(3, 16, 24, bits=12)
    raw = testdata.to_raw_bytes(frames, shift=4, big_endian=True)
    imgs = np.frombuffer(raw, dtype="<u2").reshape(3, 16, 24)
    fpv1 = encode_file(imgs, shift=4, big_endian=True)
    out = _to_fpvt(fpv1, shift=4, big_endian=True)
    hdr = Header.parse(out)
    assert hdr.big_endian and hdr.shift == 4
    np.testing.assert_array_equal(decode_file_fpvt(out), decode_file(fpv1))
    back = _to_fpv1(out)
    np.testing.assert_array_equal(decode_file(back), decode_file(fpv1))
    assert back == fpv1


def test_transcode_same_profile_is_identity():
    frames = testdata.plasma_frames(2, 16, 16)
    fpv1 = encode_file(frames)
    assert tt.transcode(fpv1, "fpv1", **CPU) == fpv1
    assert fpv_tpu_torch.transcode(fpv1, "fpv1", **CPU) == jt.transcode(
        fpv1, "fpv1")
    with pytest.raises(ValueError, match="unknown profile"):
        tt.transcode(fpv1, "zip", **CPU)


@requires_reference
def test_reference_file_to_fpvt_and_back():
    """A file produced by the compiled reference transcodes to FPVT and
    back; the final FPV1 decodes to the reference stream's exact pixels."""
    frames = testdata.plasma_frames(4, 24, 40, bits=12)
    raw = testdata.to_raw_bytes(frames, shift=4)
    ref_file = ref_encode(raw, 40, 24, 0, 4)
    fpvt = _to_fpvt(ref_file, shift=4, frames_per_batch=2)
    np.testing.assert_array_equal(decode_file_fpvt(fpvt), decode_file(ref_file))
    back = _to_fpv1(fpvt)
    np.testing.assert_array_equal(decode_file(back), decode_file(ref_file))


def test_cli_transcode_pipe():
    frames = testdata.plasma_frames(3, 16, 24, bits=12)
    fpv1 = encode_file(frames, shift=4)
    fpvt = run_port_cli("transcode", ["fpvt", "4"], fpv1)
    assert fpvt == jt.transcode_to_fpvt(fpv1, shift=4)
    back = run_port_cli("transcode", ["fpv1"], fpvt)
    assert back == fpv1
    np.testing.assert_array_equal(decode_file(back), decode_file(fpv1))


def test_cli_transcode_usage():
    p = subprocess.run(
        [sys.executable, "-m", "fpv_tpu_torch.cli.transcode", "gif",
         "--device", "cpu"],
        input=b"", capture_output=True, cwd=REPO,
    )
    assert p.returncode == 1 and b"Usage" in p.stderr


@pytest.mark.parametrize("shape,fpb", [((5, 24, 40), 3), ((9, 64, 128), 4)],
                         ids=["5x24x40", "9x64x128"])
def test_fpv1_fpvt_fpv1_returns_the_input(shape, fpb):
    frames = testdata.plasma_frames(*shape, bits=12, seed=4)
    fpv1 = fpv_tpu_torch.encode_file(frames, shift=4, **CPU)
    fpvt = _to_fpvt(fpv1, shift=4, frames_per_batch=fpb)
    assert _to_fpv1(fpvt) == fpv1


def test_fpv1_to_fpvt_wide_geometry(monkeypatch):
    """Above the narrow bound (lowered to 0 on both sides) the batches
    take the fused 1024-lane route: the JAX side runs its pallas engine."""
    monkeypatch.setenv("FPV_TPU_NARROW_MAX", "0")
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "pallas")
    monkeypatch.setattr(tpc, "NARROW_MAX_SYMS", 0)
    frames = testdata.plasma_frames(3, 64, 64, bits=12, seed=6)
    fpv1 = encode_file(frames, shift=4)
    out = _to_fpvt(fpv1, shift=4, frames_per_batch=2, chunk_log2=4)
    from fpv_tpu_torch.format import fpvt as tfpvt

    off, _n = tfpvt.parse_footer(out)[0]
    assert tfpvt.parse_batch_section(out, off).high.lanes == 1024
    assert _to_fpv1(out) == fpv1


def test_entry_points_default_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    fpv1 = encode_file(testdata.plasma_frames(2, 8, 8))
    for call in (lambda: tt.transcode_to_fpvt(fpv1),
                 lambda: tt.transcode(fpv1, "fpvt"),
                 lambda: tt.transcode_to_fpv1(encode_file_fpvt(
                     testdata.plasma_frames(2, 8, 8)))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()

"""Property-based mirrors of tests/test_property.py on the port (hypothesis,
random shapes and configurations, few examples), each also holding the
port's bytes to the JAX package's; and port copies of the crafted-stream
rejections of tests/test_format_v4.py and tests/test_raw.py (every one a
ValueError)."""

import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from fpv_tpu.api.encoder import encode_file as jencode_file
from fpv_tpu.api.fpvt_codec import encode_file_fpvt as jencode_file_fpvt
from fpv_tpu.entropy import plane_codec as jpc
from fpv_tpu.format import fpvt as jfpvt
import fpv_tpu_torch
from fpv_tpu_torch.api.frame import unextract_frame
from fpv_tpu_torch.entropy import plane_codec as tpc
from fpv_tpu_torch.format import fpvt as tfpvt
from fpv_tpu_torch.ops.rans_layout import CODING_CONST, CODING_CTX16
from fpv_tpu_torch.utils import testdata


@settings(max_examples=5, deadline=None, derandomize=True)
@given(
    n=st.integers(1, 4),
    h=st.integers(8, 40).map(lambda x: x * 4),
    w=st.integers(8, 40).map(lambda x: x * 4),
    shift=st.sampled_from([0, 2, 4, 8]),
    big_endian=st.booleans(),
    seed=st.integers(0, 2**31 - 1),
)
def test_fpv1_roundtrip_random(n, h, w, shift, big_endian, seed):
    """Raw bytes -> encode -> decode -> unextract == raw, and the bytes
    equal the JAX package's ``encode_file``."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 1 << (16 - shift), size=(n, h, w),
                          dtype=np.uint16)
    raw = testdata.to_raw_bytes(values, big_endian=big_endian)
    imgs = np.frombuffer(raw, dtype="<u2").reshape(n, h, w)
    data = fpv_tpu_torch.encode_file(imgs, shift=shift,
                                     big_endian=big_endian, num_threads=0,
                                     device="cpu")
    assert data == jencode_file(imgs, shift=shift, big_endian=big_endian,
                                num_threads=0)
    out = fpv_tpu_torch.decode_file(data, device="cpu")
    assert b"".join(unextract_frame(out[i], shift, big_endian).tobytes()
                    for i in range(n)) == raw


@settings(max_examples=5, deadline=None, derandomize=True)
@given(
    n=st.integers(1, 5),
    h=st.integers(4, 20).map(lambda x: x * 4),
    w=st.integers(4, 20).map(lambda x: x * 4),
    shift=st.sampled_from([0, 4]),
    fpb=st.integers(1, 4),
    klog=st.sampled_from([6, 8, 9, 10]),
    seed=st.integers(0, 2**31 - 1),
)
def test_fpvt_roundtrip_random(n, h, w, shift, fpb, klog, seed):
    """FPVT files of random geometry: the port's bytes equal the JAX
    writer's, and decode to the frames."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 1 << (16 - shift), size=(n, h, w),
                          dtype=np.uint16)
    kw = dict(shift=shift, frames_per_batch=fpb, chunk_log2=klog)
    data = fpv_tpu_torch.encode_file_fpvt(frames, device="cpu", **kw)
    assert data == jencode_file_fpvt(frames, **kw)
    out = fpv_tpu_torch.decode_file_fpvt(data, device="cpu")
    np.testing.assert_array_equal(out, (frames << shift).astype(np.uint16))


def _same_stream_bytes(port_stream, jax_stream):
    assert (tfpvt.serialize_plane_stream(port_stream)
            == jfpvt.serialize_plane_stream(jax_stream))


@settings(max_examples=4, deadline=None, derandomize=True)
@given(
    b=st.integers(1, 3),
    s=st.integers(1, 3000),
    # the port's kernels take power-of-two chunk lengths (the JAX test's
    # 257 runs on its numpy engine only; no JAX writer emits one)
    k=st.sampled_from([32, 64, 256, 512, 1024]),
    loc=st.integers(0, 255),
    scale=st.integers(1, 80),
    seed=st.integers(0, 2**31 - 1),
)
def test_rans_plane_roundtrip_random(b, s, k, loc, scale, seed):
    """Order-0 plane batches at odd sizes and chunk lengths (1024:
    segmented): the stream's bytes equal the JAX numpy engine's and it
    decodes to the plane."""
    rng = np.random.default_rng(seed)
    planes = ((rng.normal(loc, scale, size=(b, s))).astype(np.int64)
              % 256).astype(np.uint8)
    hist = np.bincount(planes.reshape(-1), minlength=256)
    got = tpc.encode_plane_batch(torch.from_numpy(planes), hist, k)
    _same_stream_bytes(got, jpc.encode_plane_batch(planes, hist, chunk_len=k,
                                                   engine="numpy"))
    np.testing.assert_array_equal(
        tpc.decode_plane_batch(got, "cpu").numpy(), planes)


@settings(max_examples=3, deadline=None, derandomize=True)
@given(
    b=st.integers(1, 3),
    s=st.integers(16, 2500),
    k=st.sampled_from([32, 128, 512]),
    scale=st.integers(1, 40),
    seed=st.integers(0, 2**31 - 1),
)
def test_rans_ctx16_roundtrip_random(b, s, k, scale, seed):
    """Context-coded (nibble) plane batches of low-nibble-zero values in
    the 1024-lane geometry: bytes equal to the JAX device engine's (run in
    interpret mode; its table counts the padded positions too, as the
    port's 1024-lane route does, where JAX's numpy engine counts the coded
    ones only), and lossless."""
    rng = np.random.default_rng(seed)
    planes = ((rng.normal(0, scale, size=(b, s))).astype(np.int64) % 16
              * 16).astype(np.uint8)
    got = tpc.encode_plane_batch(torch.from_numpy(planes), None, k,
                                 coding=CODING_CTX16)
    _same_stream_bytes(got, jpc.encode_plane_batch(
        planes, None, chunk_len=k, engine="pallas", coding=CODING_CTX16))
    np.testing.assert_array_equal(
        tpc.decode_plane_batch(got, "cpu").numpy(), planes)


@settings(max_examples=5, deadline=None, derandomize=True)
@given(
    b=st.integers(1, 3),
    s=st.integers(1, 3000),
    const=st.booleans(),
    seed=st.integers(0, 2**31 - 1),
)
def test_rans_auto_policy_roundtrip_random(b, s, const, seed):
    """lanes='auto' (narrow geometry, the const short-circuit): the bytes
    equal the JAX numpy engine's and survive serialize -> parse."""
    rng = np.random.default_rng(seed)
    if const:
        planes = np.full((b, s), int(rng.integers(0, 256)), np.uint8)
    else:
        planes = rng.integers(0, 256, size=(b, s), dtype=np.uint8)
    stream = tpc.encode_plane_batch(torch.from_numpy(planes), None, 4096,
                                    lanes="auto")
    if const:
        assert stream.coding == CODING_CONST
    _same_stream_bytes(stream, jpc.encode_plane_batch(
        planes, None, engine="numpy", lanes="auto"))
    blob = tfpvt.serialize_plane_stream(stream)
    parsed, end = tfpvt.parse_plane_stream(blob, 0, b, expect_size=s)
    assert end == len(blob)
    np.testing.assert_array_equal(
        tpc.decode_plane_batch(parsed, "cpu").numpy(), planes)


# ---------------------------------------------------------------------------
# crafted streams (tests/test_format_v4.py, tests/test_raw.py)


def _ramp_frames(n=8, h=64, w=96):
    return np.tile((np.arange(h * w) % 4096).astype(np.uint16)
                   .reshape(1, h, w), (n, 1, 1))


def test_parse_rejects_bad_lanes():
    fr = testdata.plasma_frames(2, 32, 32, bits=12, seed=1)
    data = bytearray(fpv_tpu_torch.encode_file_fpvt(
        fr, shift=4, frames_per_batch=2, device="cpu"))
    pos = tfpvt.HEADER_SIZE + 9 + 1  # delta section body, past dflags
    struct.pack_into("<H", data, pos + 20, 7)  # lanes=7: not a power of 2
    with pytest.raises(ValueError):
        tfpvt.parse_plane_stream(bytes(data), pos, 1)


def test_parse_rejects_const_value_over_255():
    blob = bytearray(tfpvt.serialize_plane_stream(
        tpc.const_plane_stream(1, 64, 16, 3)))
    struct.pack_into("<H", blob, 4 + 18, 300)
    with pytest.raises(ValueError):
        tfpvt.parse_plane_stream(bytes(blob), 0, 1)


def _const_high_stream():
    """A file whose first batch's high stream is CONST, and that stream's
    position -> (bytes, section offset, stream offset)."""
    fr = _ramp_frames(3, 32, 32)
    data = bytearray(fpv_tpu_torch.encode_file_fpvt(
        fr, shift=4, frames_per_batch=2, device="cpu"))
    off, _n = tfpvt.parse_footer(bytes(data))[0]
    p = off + 9 + 8 + 9 * 2  # section header, counts, flags + timestamps
    plane_size, _cl, _nc, coding = struct.unpack_from("<IIII", data, p + 4)
    assert coding == CODING_CONST and plane_size == 32 * 32
    return data, off, p


def test_parse_rejects_const_plane_size_beyond_the_geometry():
    """A CONST stream claiming plane_size 0xFFFFFFF0 is rejected at parse
    time and by the reader, before anything is allocated."""
    data, off, p = _const_high_stream()
    struct.pack_into("<I", data, p + 4, 0xFFFFFFF0)
    blob = bytes(data)
    with pytest.raises(ValueError):
        tfpvt.parse_batch_section(blob, off, plane_size=32 * 32)
    with pytest.raises(ValueError):
        fpv_tpu_torch.FpvtReader(blob, device="cpu").decode_batch(0)


def test_parse_rejects_const_chunk_len_zero():
    data, off, p = _const_high_stream()
    struct.pack_into("<I", data, p + 8, 0)  # chunk_len = 0
    with pytest.raises(ValueError):
        tfpvt.parse_batch_section(bytes(data), off, plane_size=32 * 32)


@pytest.mark.parametrize("case", ["truncated", "plane_size", "frames"])
def test_raw_malformed_inputs(case):
    """Truncated or size-inconsistent RAW streams fail at parse time."""
    data = (np.arange(64) % 256).astype(np.uint8)
    blob = tfpvt.serialize_plane_stream(tpc.raw_plane_stream(1, 64, 512, data))
    args = {"truncated": (blob[:40], 0, 1, 64),
            "plane_size": (blob, 0, 1, 32),  # claimed size != geometry
            "frames": (blob, 0, 2, 64)}[case]  # more frames than bytes
    with pytest.raises(ValueError):
        tfpvt.parse_plane_stream(*args[:3], expect_size=args[3])

"""The FPV1 compatibility profile: fpv_tpu_torch against the JAX package.

Everything runs with ``device="cpu"``, where the port's flat-CG inverse is
its plain version (``cg_flat_decode_ref``); the card runs K4 in its place
(test_torch_cuda.py).  Inputs are made from seeds with numpy.  Tolerance
everywhere: exact (byte-identical files, pixel-identical frames, equal
decisions).
"""

import struct

import numpy as np
import pytest

import fpv_tpu
from fpv_tpu.api import decoder as jdec
from fpv_tpu.api import encoder as jenc
from fpv_tpu.api import frame as jframe
from fpv_tpu.format import container as jcontainer
from fpv_tpu.models import heuristics as jheur
from fpv_tpu.models import predictors as jpred
from fpv_tpu.ops import planes as jplanes
from fpv_tpu.ops import predict as jpredict
from fpv_tpu.utils import testdata as jtestdata

import torch

import fpv_tpu_torch
from fpv_tpu_torch.api import frame as tframe
from fpv_tpu_torch.entropy import brotli as tbrotli
from fpv_tpu_torch.format import container as tcontainer
from fpv_tpu_torch.models import heuristics as theur
from fpv_tpu_torch.models import predictors as tpred
from fpv_tpu_torch.ops import planes as tplanes
from fpv_tpu_torch.utils import testdata

CPU = dict(device="cpu")

# (bits, shift, big_endian), tests/test_compat_format.py:44-51
CONFIGS = [(16, 0, False), (12, 4, False), (12, 4, True), (8, 8, False),
           (16, 0, True)]
# tests/test_compat_format.py:19-22
SHIFT_ENDIAN = [(0, False), (4, False), (8, False), (0, True), (3, True),
                (8, True)]


def _imgs(frames, big_endian):
    """Raw capture bytes reinterpreted as native-LE uint16, as the
    reference CLI feeds the encoder."""
    raw = testdata.to_raw_bytes(frames, big_endian=big_endian)
    return raw, np.frombuffer(raw, "<u2").reshape(frames.shape).copy()


def _t(a):
    return torch.from_numpy(np.array(a))


def test_testdata_copies_match_jax():
    for gen in ("ramp_frames", "constant_frames"):
        np.testing.assert_array_equal(getattr(testdata, gen)(3, 20, 28),
                                      getattr(jtestdata, gen)(3, 20, 28))
    f = testdata.plasma_frames(2, 8, 12, bits=12)
    for be in (False, True):
        raw = testdata.to_raw_bytes(f, big_endian=be)
        assert raw == jtestdata.to_raw_bytes(f, big_endian=be)
        np.testing.assert_array_equal(
            testdata.raw_to_frames(raw, 8, 12, be),
            jtestdata.raw_to_frames(raw, 8, 12, be))


@pytest.mark.parametrize("num_threads", [0, 2])
@pytest.mark.parametrize("bits,shift,big_endian", CONFIGS)
def test_encode_file_bytes_equal_jax_configs(bits, shift, big_endian,
                                             num_threads):
    frames = testdata.plasma_frames(4, 48, 64, bits=bits)
    raw, imgs = _imgs(frames, big_endian)
    want = fpv_tpu.encode_file(imgs, shift=shift, big_endian=big_endian,
                               num_threads=num_threads)
    got = fpv_tpu_torch.encode_file(imgs, shift=shift, big_endian=big_endian,
                                    num_threads=num_threads, **CPU)
    assert got == want
    # the port decodes the file back to the raw capture
    dec = fpv_tpu_torch.decode_file(got, **CPU)
    back = b"".join(tframe.unextract_frame(d, shift, big_endian).tobytes()
                    for d in dec)
    assert back == raw


@pytest.mark.parametrize("num_threads", [0, 2])
@pytest.mark.parametrize("shift,big_endian", SHIFT_ENDIAN)
def test_encode_file_bytes_equal_jax_shift_endian(shift, big_endian,
                                                  num_threads):
    frames = testdata.plasma_frames(5, 48, 64, bits=16 - shift, seed=11)
    want = fpv_tpu.encode_file(frames, shift=shift, big_endian=big_endian,
                               num_threads=num_threads)
    got = fpv_tpu_torch.encode_file(frames, shift=shift,
                                    big_endian=big_endian,
                                    num_threads=num_threads, **CPU)
    assert got == want


def test_encoder_bytes_callbacks_order_and_backpressure():
    """The Encoder session (one device step per frame) writes encode_file's
    bytes; callbacks fire in submission order with their payloads, and
    never more than max_queued() frames are in flight."""
    frames = testdata.plasma_frames(7, 32, 40, bits=12, seed=4)
    want = fpv_tpu.encode_file(frames, shift=4, num_threads=3)
    enc = fpv_tpu_torch.Encoder(num_threads=3, shift=4, **CPU)
    assert enc.max_queued() == jenc.Encoder(num_threads=3).max_queued() == 5
    assert fpv_tpu_torch.Encoder(num_threads=0, **CPU).max_queued() == 1
    got, order, in_flight = [], [], []
    enc.init(frames[0], 40, 32, lambda d, p: got.append(d))
    for i in range(len(frames)):
        buf = frames[i].copy()
        enc.compress_frame(buf, lambda d, p: (got.append(d), order.append(p)),
                           payload=i)
        buf[:] = 0  # the frame was copied at submission
        in_flight.append(len(enc._pending))
    enc.finish(lambda d, p: got.append(d))
    assert b"".join(got) == want
    assert order == list(range(len(frames)))
    assert max(in_flight) < enc.max_queued()


def test_encode_file_several_device_batches(monkeypatch):
    """encode_file's multi-frame device steps write the per-frame bytes."""
    from fpv_tpu_torch.api import encoder as tenc

    monkeypatch.setattr(tenc, "ENCODE_BATCH", 3)
    frames = testdata.plasma_frames(8, 24, 32, bits=12, seed=6)
    assert (fpv_tpu_torch.encode_file(frames, shift=4, num_threads=2, **CPU)
            == fpv_tpu.encode_file(frames, shift=4, num_threads=0))
    delta = testdata.plasma_frames(1, 24, 32, bits=12, seed=9)[0]
    assert (fpv_tpu_torch.encode_file(frames, shift=4, delta_frame=delta,
                                      num_threads=0, **CPU)
            == fpv_tpu.encode_file(frames, shift=4, delta_frame=delta,
                                   num_threads=0))


def _u8_frames(n=5, h=24, w=32, seed=7):
    """tests/test_u8.py:20-25."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, size=(h, w), dtype=np.uint8)
    return np.stack([(base + rng.integers(0, 20, size=(h, w))).astype(np.uint8)
                     for _ in range(n)])


def test_u8_frames_bytes_and_roundtrip():
    frames = _u8_frames()
    want = fpv_tpu.encode_file(frames, num_threads=2)
    data8 = fpv_tpu_torch.encode_file(frames, num_threads=2, **CPU)
    data16 = fpv_tpu_torch.encode_file(frames.astype(np.uint16), shift=8,
                                       num_threads=0, **CPU)
    assert data8 == data16 == want
    out = fpv_tpu_torch.decode_file(data8, dtype=np.uint8, **CPU)
    np.testing.assert_array_equal(out, frames)
    enc = fpv_tpu_torch.Encoder(num_threads=0, shift=0, **CPU)
    with pytest.raises(ValueError, match="uint8"):
        enc.init(frames[0], 32, 24, lambda d, p: None)
    with pytest.raises(ValueError, match="uint8"):
        fpv_tpu_torch.encode_file(frames, shift=4, **CPU)


def _encode_planes(mod, highs, lows, shift, num_threads, **kw):
    chunks = []

    def cb(data, _p):
        chunks.append(data)

    enc = mod.Encoder(num_threads=num_threads, shift=shift, **kw)
    enc.init_planes(highs[0], None if lows is None else lows[0], cb)
    for i in range(len(highs)):
        enc.compress_frame_planes(highs[i], None if lows is None else lows[i],
                                  cb)
    enc.finish(cb)
    return b"".join(chunks)


@pytest.mark.parametrize("num_threads", [0, 2])
def test_plane_ingest_bytes_equal_jax(num_threads):
    """tests/test_planes_ingest.py:53-63: planes split on the host enter the
    Encoder; bytes equal image ingest and JAX's plane ingest."""
    frames = testdata.plasma_frames(5, 40, 56, bits=12, seed=3)
    ref = fpv_tpu.encode_file(frames, shift=4, num_threads=num_threads)
    sp = [jframe.split_planes(f, shift=4) for f in frames]
    highs = np.stack([p.high for p in sp])
    lows = np.stack([p.low for p in sp])
    got = _encode_planes(fpv_tpu_torch, highs, lows, 4, num_threads, **CPU)
    assert got == ref == _encode_planes(fpv_tpu, highs, lows, 4, num_threads)
    np.testing.assert_array_equal(fpv_tpu_torch.decode_file(got, **CPU),
                                  frames << 4)


def test_plane_ingest_without_low():
    """tests/test_planes_ingest.py:66-81: low=None and an all-zero low both
    write NO_LOW_BYTES frames, the bytes of image ingest of high << 8."""
    rng = np.random.default_rng(7)
    highs = rng.integers(0, 256, (3, 24, 40), dtype=np.uint8)
    ref = fpv_tpu.encode_file(highs.astype(np.uint16) << 8, num_threads=0)
    assert _encode_planes(fpv_tpu_torch, highs, None, 0, 0, **CPU) == ref
    assert _encode_planes(fpv_tpu_torch, highs, np.zeros_like(highs), 0, 0,
                          **CPU) == ref
    # a plane-ingested delta frame without low beside frames with one
    lows = rng.integers(0, 256, (3, 24, 40), dtype=np.uint8)
    mixed = [_encode_planes(m, highs, lows, 0, 0, **kw) for m, kw in
             ((fpv_tpu_torch, CPU), (fpv_tpu, {}))]
    assert mixed[0] == mixed[1]


def test_split_and_adopt_planes_match_jax():
    for shift, be in SHIFT_ENDIAN:
        imgs = testdata.plasma_frames(3, 16, 20, bits=16 - shift, seed=2)
        got = tframe.split_planes(_t(imgs.view(np.int16)).to(torch.int32)
                                  & 0xFFFF, shift, be)
        for i, img in enumerate(imgs):
            want = jframe.split_planes(img, shift, be)
            np.testing.assert_array_equal(got.high[i].numpy(), want.high)
            low = np.zeros_like(want.high) if want.low is None else want.low
            np.testing.assert_array_equal(got.low[i].numpy(), low)
            assert got.flags[i] == want.flags
    u8 = _u8_frames(2)
    got = tframe.split_planes(_t(u8))
    np.testing.assert_array_equal(got.high.numpy(), u8)
    assert got.flags == [jframe.split_planes(u8[0]).flags] * 2
    sp = jframe.split_planes(testdata.plasma_frames(1, 8, 8, bits=12)[0], 4)
    for low in (sp.low, None, np.zeros_like(sp.low)):
        ad = tframe.adopt_planes(_t(sp.high[None]),
                                 None if low is None else _t(low[None]))
        assert ad.flags == [jframe.adopt_planes(sp.high, low).flags]


def test_combine_and_unextract_match_jax():
    rng = np.random.default_rng(1)
    h, lo, dh, dl = (rng.integers(0, 256, (2, 6, 10), dtype=np.uint8)
                     for _ in range(4))
    np.testing.assert_array_equal(
        tframe.combine_planes_delta(_t(h), _t(lo), _t(dh), _t(dl)).numpy(),
        np.asarray(jplanes.combine_planes_delta(h, lo, dh, dl)))
    np.testing.assert_array_equal(
        tframe.combine_planes(_t(h), _t(lo)).numpy(),
        np.asarray(jplanes.combine_planes(h, lo)))
    img = rng.integers(0, 65536, (2, 6, 10), dtype=np.uint16)
    for shift, be in SHIFT_ENDIAN:
        np.testing.assert_array_equal(
            tplanes.unextract(_t(img.view(np.int16)), shift, be).numpy(),
            np.asarray(jplanes.unextract(img, shift, be)))
        assert (tframe.unextract_frame(img[0], shift, be).tobytes()
                == jframe.unextract_frame(img[0], shift, be).tobytes())


def _hist(values):
    return np.bincount(values, minlength=256)


def test_estimate_entropy_matches_jax_including_int32_wrap():
    rng = np.random.default_rng(0)
    cases = [np.zeros(256, np.int64), _hist([0] * 9), _hist([3, 3, 7]),
             rng.integers(0, 1000, 256)]
    wrap = np.zeros(256, np.int64)
    wrap[:3] = [1 << 30, 1 << 29, 5]  # the log-sum passes 2^31
    cases.append(wrap)
    big = np.full(256, (1 << 31) // 200, np.int64)  # the sum wraps int32
    cases.append(big)
    lopsided = np.zeros(256, np.int64)
    lopsided[[0, 1]] = [(1 << 31) - 5, 3]
    cases.append(lopsided)
    for c in cases:
        assert theur.estimate_entropy(c) == jheur.estimate_entropy(c)
        countd = np.zeros(256, np.uint64)
        countd[0] = int(c.sum())  # decide_delta's degenerate histogram
        assert theur.decide_delta(c) == (jheur.estimate_entropy(countd)
                                         < jheur.estimate_entropy(c))
    for a, b in ((cases[3], cases[2]), (cases[2], cases[3]),
                 (cases[4], cases[5])):
        assert theur.decide_cg(a, b) == (jheur.estimate_entropy(b)
                                         < jheur.estimate_entropy(a))


def _decision_planes():
    """Constant and near-constant planes (tests/test_ops.py:110-122),
    noise, smooth 8-bit content and the high bytes of 16-bit content."""
    rng = np.random.default_rng(5)
    const = np.full((24, 40), 77, np.uint8)
    near = const.copy()
    near[3, 5] = 78
    one = const.copy()
    one[0, 0] = 0  # sampled by decide_delta only
    noise = rng.integers(0, 256, (24, 40), dtype=np.uint8)
    smooth = (testdata.plasma_frames(1, 24, 40, bits=8, seed=1)[0]
              .astype(np.uint8))
    high16 = (testdata.plasma_frames(1, 24, 40, bits=16, seed=2)[0]
              >> 8).astype(np.uint8)
    ramp = (testdata.ramp_frames(1, 24, 40)[0] & 0xFF).astype(np.uint8)
    return np.stack([const, near, one, noise, smooth, high16, ramp])


def test_batched_decisions_match_jax_per_frame():
    planes = _decision_planes()
    delta = np.roll(planes[4], 1, axis=1)
    for with_delta in (False, True):
        t = _t(planes)
        coded = tpred.delta_encode(t, _t(delta)) if with_delta else None
        counts = theur.decision_counts(t, coded).numpy()
        use_delta, use_cg = theur.decide(counts, with_delta)
        for i, p in enumerate(planes):
            d = with_delta and jheur.decide_delta(p)
            assert use_delta[i] == d, i
            cg_plane = jpred.delta_encode_np(p, delta) if d else p
            assert use_cg[i] == jheur.decide_cg(cg_plane), i
    # a plane with fewer than W + 2 pixels samples nothing for CG
    tiny = _t(np.arange(6, dtype=np.uint8).reshape(1, 1, 6))
    counts = theur.decision_counts(tiny).numpy()
    assert theur.decide(counts, False) == ([False], [jheur.decide_cg(
        tiny[0].numpy())])


def test_predict_matches_jax_per_frame():
    """The batch filter chain: flags, planes and previews of every frame
    equal JAX predict's."""
    planes = _decision_planes()
    rng = np.random.default_rng(9)
    lows = rng.integers(0, 256, planes.shape, dtype=np.uint8)
    lows[2] = 0
    delta_h = np.roll(planes[4], 1, axis=1)
    delta_l = rng.integers(0, 256, planes.shape[1:], dtype=np.uint8)
    batch = tframe.adopt_planes(_t(planes), _t(lows))
    delta = tframe.adopt_planes(_t(delta_h[None]), _t(delta_l[None]))
    delta = tframe.FramePlanes(high=delta.high[0], low=delta.low[0])
    got = tframe.predict(batch, delta)
    jdelta = jframe.adopt_planes(delta_h, delta_l)
    for i in range(len(planes)):
        want = jframe.predict(jframe.adopt_planes(planes[i], lows[i]), jdelta)
        assert got.flags[i] == want.flags, i
        np.testing.assert_array_equal(got.high[i].numpy(), want.high)
        np.testing.assert_array_equal(got.preview[i].numpy(), want.preview)
        if not want.flags & jframe.FrameFlags.NO_LOW_BYTES:
            np.testing.assert_array_equal(got.low[i].numpy(), want.low)
    back = tframe.unpredict(got, delta)
    np.testing.assert_array_equal(back.high.numpy(), planes)


@pytest.mark.parametrize("shape", [(2, 1, 9), (2, 2, 7), (3, 9, 1), (2, 6, 5),
                                   (1, 17, 23)])
def test_cg_flat_encode_and_decode_ref_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    res = tpred.cg_flat_encode(_t(x))
    np.testing.assert_array_equal(res.numpy(),
                                  np.asarray(jpredict.cg_flat_encode(x)))
    for b in range(shape[0]):
        np.testing.assert_array_equal(res[b].numpy(), jpred.cg_encode_np(x[b]))
    dec = tpred.cg_flat_decode_ref(res)
    np.testing.assert_array_equal(dec.numpy(), x)
    noise = rng.integers(0, 256, shape, dtype=np.uint8)  # any residual
    dec = tpred.cg_flat_decode(_t(noise))  # the CPU wrapper: the plain version
    for b in range(shape[0]):
        np.testing.assert_array_equal(dec[b].numpy(),
                                      jpred.cg_decode_np(noise[b]))


def test_cg_flat_decode_ref_grown_rows():
    """A grown preview buffer: 56 entries at stride 7 inverted as 8 rows;
    its leading 49 entries equal the inverse of the 7 x 7 preview alone."""
    rng = np.random.default_rng(3)
    ext = rng.integers(0, 256, 56, dtype=np.uint8)
    full = tpred.cg_flat_decode_ref(_t(ext.reshape(1, 8, 7)))
    np.testing.assert_array_equal(full[0].numpy(),
                                  jpred.cg_decode_np(ext.reshape(8, 7)))
    head = tpred.cg_flat_decode_ref(_t(ext[:49].reshape(1, 7, 7)))
    np.testing.assert_array_equal(full.reshape(-1)[:49].numpy(),
                                  head.reshape(-1).numpy())


@pytest.mark.parametrize("gen", [
    lambda: testdata.plasma_frames(3, 32, 32),
    lambda: testdata.ramp_frames(3, 36, 44),
    lambda: testdata.noise_frames(3, 32, 32),
    lambda: testdata.constant_frames(3, 32, 32),
], ids=["plasma", "ramp", "noise", "constant"])
def test_self_roundtrip_both_directions(gen):
    """tests/test_compat_format.py:95-108, across the two packages."""
    frames = gen()
    ours = fpv_tpu_torch.encode_file(frames, num_threads=0, **CPU)
    theirs = fpv_tpu.encode_file(frames, num_threads=0)
    assert ours == theirs
    np.testing.assert_array_equal(fpv_tpu_torch.decode_file(theirs, **CPU),
                                  frames)
    np.testing.assert_array_equal(fpv_tpu.decode_file(ours), frames)


def test_streaming_decoder_chunked_feed():
    """97-byte pieces (tests/test_compat_format.py:111-126) of a JAX file."""
    frames = testdata.plasma_frames(5, 32, 48)
    data = fpv_tpu.encode_file(frames, num_threads=2)
    dec = fpv_tpu_torch.StreamingDecoder(**CPU)
    got = []

    def cb(ok, frame, xs, ys, payload):
        assert ok and (xs, ys, payload) == (48, 32, "p")
        got.append(np.array(frame))

    for pos in range(0, len(data), 97):
        dec.decode(data[pos : pos + 97], cb, "p")
    np.testing.assert_array_equal(np.stack(got), frames)
    # the whole file in one call: one batch, the same frames
    got.clear()
    fpv_tpu_torch.StreamingDecoder(**CPU).decode(data, cb, "p")
    np.testing.assert_array_equal(np.stack(got), frames)


def test_truncated_stream_is_prefix_decodable():
    frames = testdata.plasma_frames(4, 32, 32)
    data = fpv_tpu_torch.encode_file(frames, num_threads=0, **CPU)
    cut = tcontainer.parse_footer(data)[-1] + 10
    got = []
    fpv_tpu_torch.StreamingDecoder(**CPU).decode(
        data[:cut], lambda ok, f, xs, ys, p: got.append(np.array(f)))
    np.testing.assert_array_equal(np.stack(got), frames[:3])


def test_streaming_decoder_failures_match_jax():
    """A corrupt frame is reported after the frames before it, as the JAX
    decoder reports it, and the buffer is kept."""
    frames = testdata.plasma_frames(4, 24, 32, bits=12)
    data = bytearray(fpv_tpu.encode_file(frames, shift=4, num_threads=0))
    offs = jcontainer.parse_footer(bytes(data))
    bad_brotli = bytearray(data)
    bad_brotli[offs[2] + 40] ^= 0xFF
    bad_flag = bytearray(data)
    bad_flag[offs[1] + 4] = 7
    for blob in (bad_brotli, bad_flag, data[:5] + b"\0" * 12):
        logs = []
        for dec in (fpv_tpu_torch.StreamingDecoder(**CPU),
                    jdec.StreamingDecoder()):
            log = []
            dec.decode(bytes(blob), lambda ok, f, xs, ys, p: log.append(
                (ok, None if f is None else np.array(f).tobytes())))
            logs.append((log, len(dec._buffer)))
        assert logs[0] == logs[1]


def test_random_access_and_previews_match_jax():
    frames = testdata.plasma_frames(3, 64, 64)
    data = fpv_tpu.encode_file(frames, num_threads=0)
    dec = fpv_tpu_torch.RandomAccessDecoder(**CPU)
    ref = jdec.RandomAccessDecoder()
    assert dec.init(data) and ref.init(data)
    assert (dec.numframes, dec.preview_xsize, dec.preview_ysize) == (3, 16, 16)
    np.testing.assert_array_equal(dec.delta_frame, ref.delta_frame)
    for i in (2, 0, 1):
        np.testing.assert_array_equal(dec.decode_frame(i), frames[i])
        pv = dec.decode_preview(i)
        assert pv.dtype == np.uint8
        np.testing.assert_array_equal(pv, ref.decode_preview(i))
    assert not fpv_tpu_torch.RandomAccessDecoder(**CPU).init(data[:11])
    assert not fpv_tpu_torch.RandomAccessDecoder(**CPU).init(data[:-3])


def test_decode_file_threaded_matches_sequential():
    frames = testdata.plasma_frames(6, 64, 64, bits=12)
    raw, imgs = _imgs(frames, False)
    data = fpv_tpu.encode_file(imgs, shift=4, num_threads=0)
    seq = fpv_tpu_torch.decode_file(data, **CPU)
    par = fpv_tpu_torch.decode_file(data, num_threads=4, **CPU)
    np.testing.assert_array_equal(seq, par)
    np.testing.assert_array_equal(seq, fpv_tpu.decode_file(data))


def test_decode_file_in_several_device_batches(monkeypatch):
    from fpv_tpu_torch.api import decoder as tdec

    frames = testdata.plasma_frames(5, 16, 24, bits=12, seed=2)
    data = fpv_tpu.encode_file(frames, shift=4, num_threads=0)
    monkeypatch.setattr(tdec, "MAX_BATCH_PIXELS", 2 * 16 * 24)
    np.testing.assert_array_equal(
        fpv_tpu_torch.decode_file(data, num_threads=2, **CPU), frames << 4)


def test_golden_v1_fixture_decodes():
    import pathlib

    golden = pathlib.Path(__file__).resolve().parent / "golden"
    with np.load(golden / "inputs.npz") as z:
        drift = z["drift"]
    got = fpv_tpu_torch.decode_file((golden / "v1_drift.fpv").read_bytes(),
                                    **CPU)
    np.testing.assert_array_equal(got, drift << 4)


def _with_grown_previews(data: bytes, xsize: int, ysize: int) -> bytes:
    """The file rebuilt with every CG preview coded as the reference codes
    it at dimensions that are not multiples of 4: the flat CG residual of
    a buffer grown to xsize * ysize // 16 entries at stride xsize // 4
    (fusion_power_video.cc:575-586), compressed with the port's brotli."""
    pw, ph = xsize // 4, ysize // 4
    grown = xsize * ysize // 16
    rows = -(-grown // pw)
    offs = tcontainer.parse_footer(data)
    out = bytearray(data[: offs[0]])
    new_offs = []
    rng = np.random.default_rng(4)
    for off in offs:
        ch = tcontainer.parse_frame_chunk(data, off)
        pv = data[ch.preview_start : ch.preview_start + ch.preview_size]
        main = data[ch.main_start : ch.main_start + ch.main_size]
        if pv[0] & tframe.FrameFlags.USE_CG:
            coded = np.empty(ph * pw, np.uint8)
            assert tbrotli.decompress_into(pv, 1, coded)[0] == ph * pw
            prev = tpred.cg_flat_decode_ref(_t(coded.reshape(1, ph, pw)))
            buf = np.zeros(rows * pw, np.uint8)
            buf[: ph * pw] = prev.reshape(-1).numpy()
            buf[ph * pw : grown] = rng.integers(0, 256, grown - ph * pw)
            res = tpred.cg_flat_encode(_t(buf.reshape(1, rows, pw)))
            pv = bytes([pv[0]]) + tbrotli.compress(
                res.reshape(-1)[:grown].numpy())
        new_offs.append(len(out))
        out += tcontainer.serialize_frame_chunk(pv, main)
    return bytes(out + tcontainer.serialize_footer(new_offs))


def test_grown_previews_decode_like_jax():
    h = w = 30
    frames = testdata.plasma_frames(4, h, w, bits=12, seed=21)
    data = _with_grown_previews(
        fpv_tpu_torch.encode_file(frames << 4, num_threads=0, **CPU), w, h)
    dec = fpv_tpu_torch.RandomAccessDecoder(**CPU)
    ref = jdec.RandomAccessDecoder()
    assert dec.init(data) and ref.init(data)
    grown_seen = 0
    for i in range(dec.numframes):
        ch = tcontainer.parse_frame_chunk(data, dec._frame_offsets[i])
        grown_seen += bool(data[ch.preview_start] & tframe.FrameFlags.USE_CG)
        pv = dec.decode_preview(i)
        np.testing.assert_array_equal(pv, ref.decode_preview(i))
        np.testing.assert_array_equal(
            pv, jframe.generate_preview((frames[i] >> 4).astype(np.uint8)))
        np.testing.assert_array_equal(dec.decode_frame(i), frames[i] << 4)
    assert grown_seen, "no CG preview: the test is vacuous"


def test_malformed_images_raise_value_error():
    frames = testdata.plasma_frames(3, 64, 64, bits=12)
    data = fpv_tpu_torch.encode_file(frames << 4, num_threads=0, **CPU)
    # a truncated brotli stream
    with pytest.raises(ValueError):
        tcontainer.decompress_image(b"\x00\x01\x02", 8, 8, "cpu")
    dsize = struct.unpack_from("<I", data, 8)[0]
    img_bs = data[13 : 8 + dsize]
    with pytest.raises(ValueError):
        tcontainer.decompress_image(img_bs[: len(img_bs) // 2], 64, 64, "cpu")
    # a brotli bomb: planes that decompress larger than the claimed
    # dimensions (tests/test_compat_format.py:246-266)
    with pytest.raises(ValueError, match="larger"):
        tcontainer.decompress_image(img_bs, 8, 8, "cpu")
    bomb = bytes([4]) + tbrotli.compress(np.zeros(1 << 22, np.uint8))
    with pytest.raises(ValueError, match="larger"):
        tcontainer.decompress_image(bomb, 16, 16, "cpu")
    # the smaller plane is rejected too
    with pytest.raises(ValueError, match="wrong decompressed plane size"):
        tcontainer.decompress_image(img_bs, 64, 65, "cpu")
    # a USE_DELTA image without a delta frame
    with pytest.raises(ValueError, match="delta"):
        tcontainer.decompress_image(bytes([5]) + img_bs[1:], 64, 64, "cpu")
    for bad in (b"", data[:12]):
        with pytest.raises(ValueError):
            fpv_tpu_torch.decode_file(bad, **CPU)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    frames = testdata.plasma_frames(2, 8, 8)
    data = fpv_tpu_torch.encode_file(frames, num_threads=0, **CPU)
    for call in (lambda: fpv_tpu_torch.Encoder(),
                 lambda: fpv_tpu_torch.encode_file(frames),
                 lambda: fpv_tpu_torch.StreamingDecoder(),
                 lambda: fpv_tpu_torch.RandomAccessDecoder(),
                 lambda: fpv_tpu_torch.decode_file(data)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()

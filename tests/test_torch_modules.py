"""fpv_tpu_torch modules against their JAX counterparts, exactly.

Plane split/combine, previews, spatial predictors, the host and device
frequency-table builders, the ctx16 index helpers and the per-batch model
step (every entry of its result dict).  Inputs are made from seeded numpy
generators and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpv_tpu.api import fpvt_codec as jcodec
from fpv_tpu.entropy import plane_codec as jpc
from fpv_tpu.entropy import tables as jtables
from fpv_tpu.entropy import tables_device as jtd
from fpv_tpu.ops import planes as jplanes
from fpv_tpu.ops import predict as jpredict
from fpv_tpu.ops import preview as jpreview
from fpv_tpu.ops import rans_pallas as rp
from fpv_tpu_torch.api import fpvt_codec as tcodec
from fpv_tpu_torch.entropy import plane_codec as tpc
from fpv_tpu_torch.entropy import tables as ttables
from fpv_tpu_torch.entropy import tables_device as ttd
from fpv_tpu_torch.format.fpvt import SPATIAL_UP
from fpv_tpu_torch.ops import planes as tplanes
from fpv_tpu_torch.ops import predict as tpredict
from fpv_tpu_torch.ops import preview as tpreview
from fpv_tpu_torch.ops import rans_cuda as tc
from fpv_tpu_torch.utils import testdata


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _eq(got, ref, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(
        got.astype(np.int64), np.asarray(ref).astype(np.int64), err_msg=msg
    )


def _planes(seed=5, shape=(3, 24, 40)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, shape, np.int64).astype(np.uint8)


@pytest.mark.parametrize("shift,big_endian", [(0, False), (4, False),
                                              (8, False), (12, False),
                                              (16, False), (0, True),
                                              (4, True), (8, True)])
def test_split_and_combine_planes(shift, big_endian):
    imgs = testdata.noise_frames(2, 16, 24)
    ref = jplanes.split_planes(imgs, shift, big_endian)
    got = tplanes.split_planes(_t(imgs.view(np.int16)), shift, big_endian)
    for g, r in zip(got, ref):
        _eq(g, r)
    _eq(tplanes.combine_planes(got[0], got[1]),
        jplanes.combine_planes(ref[0], ref[1]))


def test_generate_preview():
    high = _planes(shape=(2, 34, 49))
    _eq(tpreview.generate_preview(_t(high)), jpreview.generate_preview(high))


def test_spatial_predictors():
    plane = _planes()
    for tf, jf in ((tpredict.cg2d_encode, jpredict.cg2d_encode),
                   (tpredict.up_encode, jpredict.up_encode),
                   (tpredict.up_decode, jpredict.up_decode)):
        _eq(tf(_t(plane)), jf(plane), tf.__name__)
    n, w, nw = _planes(seed=9, shape=(3, 1000, 100))
    _eq(tpredict.clamped_gradient(_t(n), _t(w), _t(nw)),
        jpredict.clamped_gradient(n, w, nw))


def _hists(seed):
    """Order-0 histogram cases: sampled residual-like, sparse, even-only
    (non-contiguous support), single symbol, empty."""
    rng = np.random.default_rng(seed)
    resid = (rng.laplace(0, 6, 20000).round().astype(np.int64) % 256)
    sparse = np.zeros(256, np.int64)
    sparse[[0, 1, 2, 255]] = [5000, 40, 3, 17]
    even = np.zeros(256, np.int64)
    even[0:120:2] = rng.integers(0, 900, 60)
    single = np.zeros(256, np.int64)
    single[77] = 123456
    return [np.bincount(resid, minlength=256), sparse, even, single,
            np.zeros(256, np.int64)]


@pytest.mark.parametrize("case", range(5))
def test_normalize_freqs_device(case):
    hist = _hists(case)[case]
    masks = [None, (hist > 0).astype(np.int32),
             (np.arange(256) < 200).astype(np.int32)]
    for mask in masks:
        ref = jtd.normalize_freqs_device(
            jnp.asarray(hist, jnp.int32),
            None if mask is None else jnp.asarray(mask),
        )
        got = ttd.normalize_freqs_device(
            _t(hist), None if mask is None else _t(mask)
        )
        _eq(got, ref, f"mask={mask is not None}")
        assert int(got.sum()) == 4096
        _eq(ttd.encode_tables_device(got), jtd.encode_tables_device(ref)[0]
            .reshape(-1))
        _eq(ttd.fused_decode_tables_device(got).numpy().view(np.uint32),
            jtd.fused_decode_tables_device(ref).reshape(-1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normalize_freqs_ctx_device(seed):
    rng = np.random.default_rng(seed)
    hist = rng.geometric(0.02, 512).astype(np.int64) - 1
    hist[rng.random(512) < 0.4] = 0
    hist[16 * 5 : 16 * 7] = 0  # two contexts that never occur
    masks = [None, (hist > 0).astype(np.int32)]
    for mask in masks:
        ref = jtd.normalize_freqs_ctx_device(
            jnp.asarray(hist, jnp.int32),
            None if mask is None else jnp.asarray(mask),
        )
        got = ttd.normalize_freqs_ctx_device(
            _t(hist), None if mask is None else _t(mask)
        )
        _eq(got, ref)
        _eq(ttd.encode_tables_ctx_device(got),
            jtd.encode_tables_ctx_device(ref).reshape(-1))


def test_host_tables_and_table_arrays():
    for hist in _hists(7)[:4]:
        for kw in ({"ensure_all": True}, {"floor_mask": hist > 0}):
            f = ttables.normalize_freqs(hist, **kw)
            _eq(f, jtables.normalize_freqs(hist, **kw))
        f = ttables.normalize_freqs(hist, ensure_all=True)
        _eq(tc.table_arrays(f), rp.table_arrays(f)[0].reshape(-1))
        _eq(tc.fused_table_arrays(f), rp.fused_table_arrays(f).reshape(-1))
    rng = np.random.default_rng(3)
    jhist = rng.integers(0, 50, 512) * (rng.random(512) < 0.5)
    for mask in (None, jhist > 0):
        fc = ttables.normalize_freqs_ctx(jhist, floor_mask=mask)
        _eq(fc, jtables.normalize_freqs_ctx(jhist, floor_mask=mask))
        _eq(tc.ctx_table_arrays(fc), rp.ctx_table_arrays(fc)[0].reshape(-1))
        _eq(tc.ctx_fused_table_arrays(fc),
            rp.ctx_fused_table_arrays(fc).reshape(-1))


def test_ctx_index_helpers():
    rng = np.random.default_rng(4)
    sym4 = rng.integers(0, 16, (2, 32, 1024)).astype(np.uint8)
    sym4[:, :, 5:9] = 0
    j4 = jnp.asarray(sym4.reshape(2, 32, 8, 128).astype(np.int32))
    _eq(tpc.ctx_indices_device(_t(sym4)),
        np.asarray(jpc.ctx_indices_device(j4)).reshape(2, 32, 1024))
    _eq(tpc.ctx_presence_device(_t(sym4)), jpc.ctx_presence_device(j4))
    plane = _planes(shape=(3, 5000))
    _eq(tpc._to_block_symbols(_t(plane), 16, 1),
        np.asarray(jpc._to_block_symbols(plane, 16, 1)).reshape(1, 16, 1024))


def _step_inputs(bits, n=9, h=48, w=64):
    frames = testdata.plasma_frames(n + 1, h, w, bits=bits, seed=13)
    return frames[0], frames[1:]


@pytest.mark.parametrize(
    "bits,shift,low_ctx,allow_prev,use_delta_frame",
    [
        (12, 4, True, True, True),
        (16, 0, False, True, True),
        (16, 0, False, False, True),
        (12, 4, True, False, False),
    ],
)
def test_encode_model_step_every_entry(bits, shift, low_ctx, allow_prev,
                                       use_delta_frame):
    delta, imgs = _step_inputs(bits)
    dh, dl, _nz = jplanes.split_planes(delta[None], shift, False)
    ref = jcodec.encode_model_step(
        jnp.asarray(imgs), dh[0], dl[0], shift=shift, big_endian=False,
        use_delta_frame=use_delta_frame, low_ctx=low_ctx,
        allow_prev=allow_prev,
    )
    got = tcodec.encode_model_step(
        _t(imgs.view(np.int16)).to(torch.int32) & 0xFFFF,
        _t(dh[0]), _t(dl[0]), shift, False, use_delta_frame, low_ctx,
        allow_prev,
    )
    assert set(got) == set(ref)
    for name, r in ref.items():
        if r is None:
            assert got[name] is None, name
        else:
            _eq(got[name], r, name)
    if allow_prev:
        assert bool(got["use_prev"].any())


@pytest.fixture(scope="module")
def bench_windows():
    """The chip smoke corpus (128 x 1024^2 12-bit plasma, seed 42) cut to
    its delta frame and two 8-frame windows: the starts of its first and
    last batches (frames 1 and 97).  The generator draws frames in order,
    so these equal the corpus's frames."""
    frames = testdata.plasma_frames(105, 1024, 1024, bits=12)
    return frames[0].copy(), {1: frames[1:9].copy(), 97: frames[97:105].copy()}


@pytest.mark.parametrize("start", [1, 97])
def test_encode_model_step_bench_size(bench_windows, start):
    """At 1024^2 the decision costs' partial sums reach their largest size
    in the corpus; the port's int64 sums must still pick what JAX's float32
    sums pick.  Both choose the 'up' predictor for every frame here, so the
    smoke run's batches launch no CG2D inverse (K3 runs on the delta
    section only)."""
    delta, imgs = bench_windows[0], bench_windows[1][start]
    dh, dl, _nz = jplanes.split_planes(delta[None], 4, False)
    ref = jcodec.encode_model_step(
        jnp.asarray(imgs), dh[0], dl[0], shift=4, big_endian=False,
        use_delta_frame=True, low_ctx=True, allow_prev=True,
    )
    got = tcodec.encode_model_step(
        _t(imgs.view(np.int16)).to(torch.int32) & 0xFFFF,
        _t(dh[0]), _t(dl[0]), 4, False, True, True, True,
    )
    assert set(got) == set(ref)
    for name, r in ref.items():
        if r is None:
            assert got[name] is None, name
        else:
            _eq(got[name], r, name)
    _eq(got["spatial"], np.full(len(imgs), SPATIAL_UP))


def test_narrow_geometry():
    for n in (1, 15, 16, 17, 1000, 8 * 1024, 8 * 32768, 8 * 32768 + 1,
              3 * 1024 * 1024, tpc.NARROW_MAX_SYMS):
        assert tpc.narrow_geometry(n) == jpc._narrow_geometry(n), n
    assert tpc.NARROW_MAX_SYMS == jpc.NARROW_MAX_SYMS
    assert tpc.NARROW_MAX_K == jpc.NARROW_MAX_K


def test_u8_config_helpers():
    for shift, be in ((8, False), (0, False), (4, False), (8, True)):
        for dtype in (np.uint8, np.uint16):
            try:
                want = jplanes.resolve_u8_shift(dtype, shift, be)
            except ValueError:
                with pytest.raises(ValueError, match="shift=8"):
                    tplanes.resolve_u8_shift(dtype, shift, be)
            else:
                assert tplanes.resolve_u8_shift(dtype, shift, be) == want
        if shift == 8 and not be:
            tplanes.validate_u8_config(shift, be)
        else:
            with pytest.raises(ValueError, match="shift=8"):
                tplanes.validate_u8_config(shift, be)


def _stream_fields_equal(got, ref):
    for f in ("nframes", "plane_size", "chunk_len", "coding", "lanes"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("freq", "states", "block_counts", "payload"):
        _eq(getattr(got, f), getattr(ref, f), f)


def _resid_plane(shape, seed, width):
    """Mod-256 residual-like bytes: a narrow Laplacian around 0."""
    rng = np.random.default_rng(seed)
    return (rng.laplace(0, width, shape).round().astype(np.int64) % 256
            ).astype(np.uint8)


# (name, plane, coding, hist-or-None, lanes mode): small planes, where
# "auto" picks narrow streams, const and raw streams, and "wide"
PLANE_CASES = {
    "order0-narrow": (lambda: _resid_plane((3, 40, 56), 1, 3), 0, True, "auto"),
    "order0-exact-hist": (lambda: _resid_plane((2, 65, 91), 2, 2), 0, False,
                          "auto"),
    "ctx16-narrow": (lambda: _resid_plane((3, 40, 56), 3, 20) & 0xF0, 1, False,
                     "auto"),
    "const": (lambda: np.full((2, 24, 24), 7, np.uint8), 0, True, "auto"),
    "noise-raw": (lambda: _planes(seed=4, shape=(2, 48, 48)), 0, True, "auto"),
    "order0-wide": (lambda: _resid_plane((4, 128, 128), 5, 4), 0, True,
                    "wide"),
}


@pytest.mark.parametrize("name", list(PLANE_CASES))
def test_encode_plane_batch_policy_matches_jax(name):
    """The narrow policy and narrow coding against the JAX package's default
    (host) engine: every PlaneStream field, including the ctx16 tables,
    which the narrow route takes from an exact histogram of the coded
    positions."""
    make, coding, with_hist, lanes = PLANE_CASES[name]
    plane = make()
    b = plane.shape[0]
    flat = plane.reshape(b, -1)
    hist = np.bincount(flat[:, ::3].reshape(-1), minlength=256) if with_hist \
        else None
    mask = (np.bincount(flat.reshape(-1), minlength=256) > 0) if with_hist \
        else None
    ref = jpc.encode_plane_batch(flat, hist, 256, engine="numpy",
                                 coding=coding, mask=mask, lanes=lanes)
    got = tpc.encode_plane_batch(_t(flat), hist, 256, coding=coding,
                                 mask=mask, lanes=lanes)
    _stream_fields_equal(got, ref)
    want = {"const": 2, "noise-raw": 3}.get(name, coding)
    assert got.coding == want
    if name.endswith("narrow"):
        assert got.lanes < 1024
    np.testing.assert_array_equal(
        tpc.decode_plane_batch(got, "cpu").numpy(), flat
    )


def test_encode_plane_batch_wide_ctx16_matches_jax_device_route(monkeypatch):
    """1024-lane ctx16 streams take their table from the full block array
    (padding included), as the JAX device (pallas) route does."""
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "pallas")
    plane = (_resid_plane((1, 120, 500), 6, 20) & 0xF0).reshape(1, -1)
    ref = jpc.encode_plane_batch(plane, None, 64, coding=1, lanes="wide")
    got = tpc.encode_plane_batch(_t(plane), None, 64, coding=1, lanes="wide")
    assert got.lanes == 1024 and got.coding == 1
    _stream_fields_equal(got, ref)


def test_grouped_plane_coding_equals_per_plane():
    """code_planes on several plane batches (order-0 and ctx16 at different
    chunk lengths and lane counts, noise that stores raw) equals one call
    per plane, and decode_plane_ranges on those streams plus a constant
    one equals decode_plane_batch per stream."""
    jobs = []
    for plane, k, lanes, coding in (
        (_resid_plane((3, 40, 56), 1, 3), 1024, 8, 0),
        (_resid_plane((3, 40, 56), 3, 20) & 0xF0, 256, 1024, 1),
        (_planes(seed=4, shape=(2, 48, 48)), 16, 1024, 0),
    ):
        flat = _t(plane.reshape(plane.shape[0], -1))
        syms, lens, fc, freq = tpc.plane_blocks(flat, k, lanes, coding)
        jobs.append(tpc.PlaneJob(flat, syms, lens, fc, freq, coding))
    grouped = tpc.code_planes(jobs)
    assert [st.coding for st in grouped] == [0, 1, 3]
    for job, got in zip(jobs, grouped):
        _stream_fields_equal(got, tpc.code_planes([job])[0])
    streams = grouped + [tpc.const_plane_stream(2, 100, 64, 9)]
    requests = [(f"p{i}", st, 5, st.nframes * st.plane_size - 3)
                for i, st in enumerate(streams)]
    for (_n, st, lo, hi), got in zip(
            requests, tpc.decode_plane_ranges(requests, "cpu")):
        _eq(got, tpc.decode_plane_batch(st, "cpu").reshape(-1)[lo:hi])
    for job, st in zip(jobs, grouped):
        _eq(tpc.decode_plane_batch(st, "cpu"), job.plane)


def test_grouped_decode_names_the_failing_plane():
    plane = _t(_resid_plane((2, 40, 56), 5, 3).reshape(2, -1))
    good = tpc.encode_plane_batch(plane, None, 64, lanes=1024)
    bad = tpc.encode_plane_batch(plane, None, 64, lanes=1024)
    bad.payload = bad.payload.copy()
    bad.payload[len(bad.payload) // 2] ^= 0x5A5A
    with pytest.raises(ValueError, match=r"integrity.*\(low plane\)"):
        tpc.decode_plane_ranges([("high", good, 0, 10), ("low", bad, 0, 10)],
                                "cpu")


def test_encode_model_step_float32_cost_sums():
    """The decision costs' sums pass 2^24 on 4096^2 frames: JAX sums them in
    float32, the port exactly in int64.  On two frames of 16-bit noise
    (shift 0) every per-frame decision must still agree."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 1 << 16, (3, 4096, 4096), dtype=np.uint16)
    delta, imgs = frames[0], frames[1:]
    dh, dl, _nz = jplanes.split_planes(delta[None], 0, False)
    ref = jcodec.encode_model_step(
        jnp.asarray(imgs), dh[0], dl[0], shift=0, big_endian=False,
        use_delta_frame=True, low_ctx=False, allow_prev=True,
    )
    high = _t(imgs.view(np.int16)).to(torch.int32) & 0xFFFF
    got = tcodec.encode_model_step(high, _t(dh[0]), _t(dl[0]), 0, False,
                                   True, False, True)
    sums = tcodec._residual_cost(tplanes.split_planes(high, 0, False)[0])
    assert float(sums.min()) > 1 << 24
    for name in ("use_delta", "use_prev", "spatial", "pv_spatial",
                 "pv_use_delta"):
        _eq(got[name], ref[name], name)

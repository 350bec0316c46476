"""The port's multi-device layer (fpv_tpu_torch.parallel.mesh) against the
JAX package's (fpv_tpu.parallel.mesh).

The JAX side runs on the 8 virtual CPU devices tests/conftest.py sets up,
its pallas kernels in interpret mode; the port's meshes are
``[torch.device("cpu")] * D``, where each kernel wrapper runs its plain
version.  The same seeded numpy inputs go through both, and every
comparison is exact.  The port has no FPV_TPU_NARROW_MAX: tests that need
the fused 1024-lane geometry pin its narrow bound to 0 with monkeypatch.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpv_tpu.api import fpvt_codec as jcodec
from fpv_tpu.format import fpvt as jfpvt
from fpv_tpu.parallel import mesh as pmesh
from fpv_tpu.utils import testdata
import fpv_tpu_torch
from fpv_tpu_torch.api import fpvt_codec as tcodec
from fpv_tpu_torch.entropy import plane_codec as tpc
from fpv_tpu_torch.format import fpvt as tfpvt
from fpv_tpu_torch.ops import rans_cuda
from fpv_tpu_torch.ops.rans_layout import CODING_ORDER0, CODING_RAW
from fpv_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")


def _mesh(data, space=1):
    return tmesh.make_mesh(data * space, data=data, space=space,
                           devices=[CPU] * (data * space))


def _deltas(frames, shift):
    left = (frames[0].astype(np.uint32) << shift) & 0xFFFF
    return (left >> 8).astype(np.uint8), (left & 0xFF).astype(np.uint8)


def _port_single(frames, dh, dl, shift):
    return tcodec.encode_model_step(
        torch.from_numpy(frames.astype(np.int32)), torch.from_numpy(dh),
        torch.from_numpy(dl), shift, False)


def _assert_steps_equal(got, want, keys=None):
    for k in keys or [k for k in want if want[k] is not None]:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("data,space,shape", [
    (4, 1, (8, 32, 32)),  # tests/test_parallel.py:19
    (2, 2, (4, 64, 32)),  # tests/test_parallel.py:42
], ids=["data4", "data2-space2"])
def test_sharded_model_step_matches_jax_and_single_device(data, space, shape):
    frames = testdata.plasma_frames(*shape, bits=12)
    dh, dl = _deltas(frames, 4)
    got = tmesh.sharded_encode_model_step(_mesh(data, space), shift=4)(
        frames, dh, dl)
    single = _port_single(frames, dh, dl, 4)
    _assert_steps_equal(got, single)
    m = pmesh.make_mesh(data * space, data=data, space=space)
    jax_out = pmesh.sharded_encode_model_step(m, shift=4)(
        pmesh.shard_frames(frames, m), dh, dl)
    _assert_steps_equal(got, jax_out, ["high", "low", "preview", "hist_high",
                                       "mask_high", "spatial", "use_delta",
                                       "pv_spatial", "pv_use_delta"])


def _mixed_frames(n, h, w, seed):
    """Plasma frames with noise frames and ramps mixed in: the temporal,
    spatial and preview decisions differ from frame to frame."""
    rng = np.random.default_rng(seed)
    frames = testdata.plasma_frames(n, h, w, bits=12, seed=seed)
    frames[1::3] = rng.integers(0, 4096, size=frames[1::3].shape)
    yy, xx = np.mgrid[0:h, 0:w]
    frames[2::4] = (yy * 37 + xx * 11) % 4096
    return frames


@pytest.mark.parametrize("data,space,shape", [
    (2, 4, (8, 64, 32)),  # 16 rows a shard: the sampled rows straddle cuts
    (4, 2, (16, 96, 24)),
    (2, 5, (8, 40, 40)),  # 8 rows a shard: preview rows cross cuts
    (1, 8, (2, 16, 16)),  # 2 rows a shard: a preview row spans two shards
    (2, 2, (4, 16, 3)),  # no preview columns
    (1, 3, (3, 3, 8)),  # no preview rows, one row a shard
])
def test_sharded_model_step_space_axis_halos(data, space, shape):
    """Row shards read halo rows across every kind of cut, and decisions
    that sample rows by global index: outputs equal the single-device
    step."""
    frames = _mixed_frames(*shape, seed=space)
    dh, dl = _deltas(frames, 4)
    got = tmesh.sharded_encode_model_step(_mesh(data, space), shift=4)(
        frames, dh, dl)
    want = _port_single(frames, dh, dl, 4)
    _assert_steps_equal(got, want)
    assert len(set(want["spatial"].tolist())) > 1 or shape[1] < 4


def _jax_shard_sections(outs, frames, dh, dl, d, nd, k):
    """Shard ``d`` of JAX's sharded_fused_encode outputs packaged and
    serialized as its sharded_encode_file packages them."""
    small_g, st_g = np.asarray(outs[0]), np.asarray(outs[1])
    pays = [np.asarray(p) for p in outs[2:]]
    L, SL = small_g.size // nd, st_g.size // nd
    bl, h, w = frames.shape[0] // nd, frames.shape[1], frames.shape[2]
    flags, streams = jcodec.package_encoded_batch(
        small_g[d * L : (d + 1) * L], st_g[d * SL : (d + 1) * SL],
        *(p[d * (p.shape[0] // nd) : (d + 1) * (p.shape[0] // nd)]
          for p in pays),
        b=bl, h=h, w=w, chunk_len=k, low_coding=0,
        raw_ctx=dict(imgs=frames[d * bl : (d + 1) * bl],
                     delta_high=jnp.asarray(dh), delta_low=jnp.asarray(dl),
                     shift=0, big_endian=False))
    return jfpvt.serialize_batch_section(flags, np.full(bl, -1, np.int64),
                                         *streams)


def test_sharded_fused_encode_each_shard_equals_its_slice():
    """tests/test_parallel.py:66: each shard's streams equal
    fused_encode_batch on its frame slice alone, and JAX's shard."""
    nd, h, w, k = 4, 16, 16, 16
    frames = testdata.plasma_frames(8, h, w, bits=12)
    dh, dl = (frames[0] >> 8).astype(np.uint8), (frames[0] & 0xFF).astype(
        np.uint8)
    outs = tmesh.sharded_fused_encode(_mesh(nd), chunk_len=k)(frames, dh, dl)
    m = pmesh.make_mesh(nd, data=nd)
    jouts = pmesh.sharded_fused_encode(m, chunk_len=k)(
        pmesh.shard_frames(frames, m), jnp.asarray(dh), jnp.asarray(dl))
    ts = np.full(2, -1, np.int64)
    for d, (flags, streams) in enumerate(outs):
        got = tfpvt.serialize_batch_section(flags, ts, *streams)
        want = tcodec.fused_encode_batch(
            tcodec.put_frames(frames[2 * d : 2 * d + 2], CPU),
            torch.from_numpy(dh), torch.from_numpy(dl), 0, False, k,
            allow_prev=False)
        assert got == tfpvt.serialize_batch_section(want[0], ts, *want[1])
        assert got == _jax_shard_sections(jouts, frames, dh, dl, d, nd, k)


@pytest.mark.parametrize("bits,chunk_len", [(16, 16), (12, 64)])
def test_sharded_codec_roundtrip_lossless(bits, chunk_len):
    """tests/test_parallel.py:109: the full codec over a 4-shard mesh."""
    frames = testdata.plasma_frames(8, 16, 16, bits=bits)
    dh, dl = (frames[0] >> 8).astype(np.uint8), (frames[0] & 0xFF).astype(
        np.uint8)
    out, ok = tmesh.sharded_codec_roundtrip(_mesh(4), chunk_len=chunk_len)(
        frames, dh, dl)
    assert ok
    np.testing.assert_array_equal(out, frames)


def test_sharded_codec_roundtrip_left_aligned_ok():
    """At shift 4 the decode gives the frames left-aligned: the port's
    ``ok`` holds it to the split frames and is true; the JAX package
    compares with the unshifted input, and its ``ok`` is false although
    its frames are the same (a divergence by design)."""
    frames = testdata.plasma_frames(8, 16, 16, bits=12, seed=11)
    dh, dl = _deltas(frames, 4)
    out, ok = tmesh.sharded_codec_roundtrip(_mesh(4), chunk_len=16, shift=4)(
        frames, dh, dl)
    assert ok
    np.testing.assert_array_equal(out, frames << 4)
    m = pmesh.make_mesh(4, data=4)
    jout, jok = pmesh.sharded_codec_roundtrip(m, chunk_len=16, shift=4)(
        pmesh.shard_frames(frames, m), jnp.asarray(dh), jnp.asarray(dl))
    assert not bool(jok)
    np.testing.assert_array_equal(np.asarray(jout), out)


def test_sharded_codec_roundtrip_ok_covers_integrity(monkeypatch):
    """A failing rANS integrity flag on one shard makes ``ok`` false."""
    real = rans_cuda.rans_decode_ref
    calls, lock = [], threading.Lock()

    def flaky(*args):
        syms, ok = real(*args)
        with lock:  # the shards decode on threads of their own
            calls.append(1)
            n = len(calls)
        return syms, ok * (n != 2)

    monkeypatch.setattr(rans_cuda, "rans_decode_ref", flaky)
    frames = testdata.plasma_frames(4, 16, 16, bits=16)
    _out, ok = tmesh.sharded_codec_roundtrip(_mesh(2), chunk_len=16)(
        frames, *_deltas(frames, 0))
    assert not ok and calls


def _mixed_section_file(monkeypatch, nd):
    """tests/test_parallel.py:123's file, written by the JAX package:
    device-geometry noise sections, CODING_CONST sections and a narrow
    section."""
    monkeypatch.setenv("FPV_TPU_RAW", "0")  # keep tiny sections rANS-coded
    h, w, bpb, shift = 32, 32, 2, 4
    rng = np.random.default_rng(7)
    wtr = jcodec.FpvtWriter(w, h, shift=shift, frames_per_batch=bpb,
                            chunk_log2=5)
    base = testdata.plasma_frames(1, h, w, bits=12)[0]
    parts = [wtr.init(base)]
    frames = []

    def add_fused(sub):
        flags, (hs, ls, pvs) = wtr._encode_batch_fused(wtr._put(sub),
                                                       sub.shape[0])
        sec = jfpvt.serialize_batch_section(
            flags, np.full(sub.shape[0], -1, np.int64), hs, ls, pvs)
        parts.append(wtr.add_batch(sec, sub.shape[0]))
        frames.append(sub)

    for _ in range(2 * nd):
        add_fused(rng.integers(0, 1 << 12, size=(bpb, h, w), dtype=np.uint16))
    for _ in range(nd):
        add_fused(np.broadcast_to(base, (bpb, h, w)).copy())
    sub = rng.integers(0, 1 << 12, size=(bpb, h, w), dtype=np.uint16)
    parts.append(wtr.encode_batch(sub))
    frames.append(sub)
    parts.append(wtr.finish())
    want = (np.concatenate(frames).astype(np.uint32) << shift).astype(
        np.uint16)
    return b"".join(parts), want


def test_sharded_decode_file_mixed_sections(monkeypatch):
    nd = 2
    data, want = _mixed_section_file(monkeypatch, nd)
    m = pmesh.make_mesh(nd, data=nd)
    mesh = _mesh(nd)
    out = tmesh.sharded_decode_file(data, mesh)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, pmesh.sharded_decode_file(data, m))
    out2, pv = tmesh.sharded_decode_file(data, mesh, want_previews=True)
    np.testing.assert_array_equal(out2, want)
    jout, jpv = pmesh.sharded_decode_file(data, m, want_previews=True)
    np.testing.assert_array_equal(pv, jpv)
    rdr = fpv_tpu_torch.FpvtReader(data, device="cpu")
    np.testing.assert_array_equal(pv, np.concatenate(
        [rdr.decode_batch_with_previews(i)[1]
         for i in range(rdr.num_batches)]))


def test_sharded_decode_file_frame0_and_previews(monkeypatch):
    """A delta_is_frame0 file through 3 shards with a partial group: frame
    0 and its preview come first, as the reader gives them."""
    monkeypatch.setattr(tpc, "NARROW_MAX_SYMS", 0)
    frames = testdata.plasma_frames(1 + 4 * 2 + 1, 16, 24, bits=12, seed=9)
    data = fpv_tpu_torch.encode_file_fpvt(frames, shift=4, frames_per_batch=2,
                                          chunk_log2=4, device="cpu")
    out, pv = tmesh.sharded_decode_file(data, _mesh(3), want_previews=True)
    np.testing.assert_array_equal(out, frames << 4)
    jout, jpv = pmesh.sharded_decode_file(data, pmesh.make_mesh(3, data=3),
                                          want_previews=True)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(pv, jpv)


def test_sharded_decode_file_integrity_failure_raises(monkeypatch):
    monkeypatch.setattr(tpc, "NARROW_MAX_SYMS", 0)
    frames = testdata.plasma_frames(5, 64, 64, bits=12, seed=3)
    data = bytearray(fpv_tpu_torch.encode_file_fpvt(
        frames, shift=4, frames_per_batch=2, chunk_log2=6, device="cpu"))
    off, _n = tfpvt.parse_footer(bytes(data))[-1]
    pb = tfpvt.parse_batch_section(bytes(data), off)
    payload = pb.high.payload.tobytes()
    at = bytes(data).find(payload, off)
    assert at > 0 and pb.high.coding == CODING_ORDER0
    data[at + len(payload) // 2] ^= 0xFF
    with pytest.raises(ValueError, match="integrity"):
        tmesh.sharded_decode_file(bytes(data), _mesh(2))


def _encode_both(monkeypatch, frames, nd, **kwargs):
    """(port sharded, JAX sharded, port encode_file_fpvt) bytes with the
    fused geometry pinned on both sides (narrow bound 0)."""
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "pallas")
    monkeypatch.setenv("FPV_TPU_NARROW_MAX", "0")
    monkeypatch.setattr(tpc, "NARROW_MAX_SYMS", 0)
    got = tmesh.sharded_encode_file(frames, _mesh(nd), **kwargs)
    jax_bytes = pmesh.sharded_encode_file(
        frames, pmesh.make_mesh(nd, data=nd), **kwargs)
    single = fpv_tpu_torch.encode_file_fpvt(frames, device="cpu", **kwargs)
    return got, jax_bytes, single


def test_sharded_encode_file_byte_identical(monkeypatch):
    """tests/test_parallel.py:185: two mesh groups and a tail batch, with
    timestamps."""
    nd, h, w, bpb = 2, 16, 16, 2
    n = 1 + 2 * nd * bpb + bpb
    frames = testdata.plasma_frames(n, h, w, bits=12)
    ts = 1000 + np.arange(n, dtype=np.int64)
    got, jax_bytes, single = _encode_both(
        monkeypatch, frames, nd, shift=4, frames_per_batch=bpb, chunk_log2=4,
        timestamps=ts)
    assert got == jax_bytes == single
    np.testing.assert_array_equal(tmesh.sharded_decode_file(got, _mesh(nd)),
                                  frames << 4)
    rdr = fpv_tpu_torch.FpvtReader(got, device="cpu")
    np.testing.assert_array_equal(
        np.concatenate([rdr.timestamps(i) for i in range(rdr.num_batches)]),
        ts[1:])


def _noisy_low_frames(n, h, w, seed):
    """tests/test_raw.py's frames: the high byte drifts smoothly while the
    low byte is iid noise (its residual stream must go raw)."""
    rng = np.random.default_rng(seed)
    base = testdata.plasma_frames(1, h, w, bits=8)[0].astype(np.uint16)
    out = np.empty((n, h, w), np.uint16)
    for t in range(n):
        hi = (base + t) & 0xFF
        out[t] = (hi << 8) | rng.integers(0, 256, size=(h, w)).astype(
            np.uint16)
    return out


def test_sharded_encode_raw_byte_identical(monkeypatch):
    """tests/test_raw.py:214: planes stored raw."""
    nd, h, w, bpb = 2, 16, 16, 2
    frames = _noisy_low_frames(1 + 2 * nd * bpb, h, w, seed=31)
    got, jax_bytes, single = _encode_both(
        monkeypatch, frames, nd, frames_per_batch=bpb, chunk_log2=4)
    assert got == jax_bytes == single
    codings = [tfpvt.parse_batch_section(got, off).low.coding
               for off, _n in tfpvt.parse_footer(got)]
    assert CODING_RAW in codings
    np.testing.assert_array_equal(tmesh.sharded_decode_file(got, _mesh(nd)),
                                  frames)


@pytest.mark.parametrize("nd,n,fpb", [(1, 7, 3), (3, 12, 2), (2, 1 + 5 * 3, 3)])
def test_sharded_encode_file_equals_writer(monkeypatch, nd, n, fpb):
    """Other mesh sizes, partial groups and tails against the port's
    single-device writer; the narrow policy (a small file) routes every
    batch through the writer."""
    frames = testdata.plasma_frames(n, 24, 32, bits=12, seed=nd)
    kw = dict(shift=4, frames_per_batch=fpb, chunk_log2=5)
    narrow = tmesh.sharded_encode_file(frames, _mesh(nd), **kw)
    assert narrow == fpv_tpu_torch.encode_file_fpvt(frames, device="cpu",
                                                    **kw)
    monkeypatch.setattr(tpc, "NARROW_MAX_SYMS", 0)
    wide = tmesh.sharded_encode_file(frames, _mesh(nd), **kw)
    assert wide == fpv_tpu_torch.encode_file_fpvt(frames, device="cpu", **kw)
    np.testing.assert_array_equal(
        tmesh.sharded_decode_file(wide, _mesh(nd)), frames << 4)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_multichip_dryrun(n):
    tmesh.multichip_dryrun(n, mesh=_mesh(n))


def test_warmup_stream_runs_the_mesh_paths(monkeypatch):
    monkeypatch.setattr(tpc, "NARROW_MAX_SYMS", 0)
    seen = []
    for name in ("sharded_encode_file", "sharded_decode_file"):
        real = getattr(tmesh, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            out = _real(*args, **kwargs)
            seen.append((_name, kwargs.get("want_previews")))
            return out

        monkeypatch.setattr(tmesh, name, spy)
    fpv_tpu_torch.warmup_stream(32, 32, shift=4, frames_per_batch=2,
                                chunk_log2=4, device="cpu", previews=True,
                                mesh=_mesh(2))
    assert seen == [("sharded_encode_file", None),
                    ("sharded_decode_file", True)]


def test_mesh_shapes_and_placement():
    m = _mesh(2, 3)
    assert m.shape == {"data": 2, "space": 3}
    assert m.axis_names == ("data", "space")
    grid = tmesh.shard_frames(np.zeros((4, 6, 5), np.uint16), m)
    assert [[t.shape for t in row] for row in grid] == [[(2, 2, 5)] * 3] * 2
    with pytest.raises(ValueError, match="split"):
        tmesh.shard_frames(np.zeros((3, 6, 5), np.uint16), m)
    with pytest.raises(ValueError, match="space"):
        tmesh.sharded_encode_file(np.zeros((5, 6, 5), np.uint16), m)
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_mesh(4, devices=[CPU] * 3)


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()

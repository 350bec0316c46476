"""The module-level device decode API of fpv_tpu_torch against the JAX
package's: ``section_rows_need``, ``batch_decode_args``,
``fused_decode_batch``, ``fused_decode_frame``, ``fused_decode_preview``
and ``parallel.mesh.sharded_fused_decode``.

The files are written by the JAX package's device (pallas) engine in
interpret mode with narrow streams off (FPV_TPU_RANS_ENGINE=pallas,
FPV_TPU_NARROW_MAX=0), as test_torch_fpvt.py writes its reference files,
once per module.  Both packages get the same arrays; every output must be
equal: arrays, frames, previews, packed bytes and ``ok``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fpv_tpu.api import fpvt_codec as jcodec
from fpv_tpu.parallel import mesh as jmesh
from fpv_tpu.utils import testdata
from fpv_tpu_torch.api import fpvt_codec as tcodec
from fpv_tpu_torch.ops.rans_layout import (
    CODING_CONST,
    CODING_CTX16,
    CODING_RAW,
)
from fpv_tpu_torch.parallel import mesh as tmesh

ARGS = ("payload", "plane_offs", "counts", "states", "flags", "sym_tabs",
        "fcs")


def _repeated(n, h, w):
    f = testdata.plasma_frames(1, h, w, bits=12, seed=3)
    return np.repeat(f, n, axis=0)


# name -> (frames, shift, frames_per_batch, chunk_log2)
CASES = {
    # ctx16 low plane, CG2D frames, prev-frame chains, a RAW preview
    "plasma-ctx16": (lambda: testdata.plasma_frames(7, 64, 128, bits=12),
                     4, 3, 8),
    # order-0 planes, coded CG2D previews with the preview delta
    "plasma-order0": (lambda: testdata.plasma_frames(3, 256, 256, bits=16,
                                                     seed=2), 0, 2, 8),
    "repeated-const": (lambda: _repeated(5, 32, 64), 4, 2, 8),
    "noise-raw": (lambda: testdata.noise_frames(5, 32, 64), 0, 2, 8),
}


@pytest.fixture(scope="module")
def files():
    """name -> (frames, shift, JAX file bytes)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FPV_TPU_RANS_ENGINE", "pallas")
        mp.setenv("FPV_TPU_NARROW_MAX", "0")
        for name, (make, shift, fpb, cl) in CASES.items():
            frames = make()
            out[name] = (frames, shift, jcodec.encode_file_fpvt(
                frames, shift=shift, frames_per_batch=fpb, chunk_log2=cl))
    return out


def _sections(data):
    """[(JAX reader, port reader, batch index, frames, JAX parsed batch,
    port parsed batch)] of a file."""
    jr = jcodec.FpvtReader(data)
    tr = tcodec.FpvtReader(data, device="cpu")
    out = []
    for bi, (off, n) in enumerate(jr._batches):
        out.append((jr, tr, bi, n, jr._parse_batch(off), tr._parse_batch(off)))
    return out


def _eq(got, ref, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    np.testing.assert_array_equal(got.astype(np.int64), ref.astype(np.int64),
                                  err_msg=msg)


def _jax_batch(jr, arrays, static, n, **kw):
    h, w = jr.header.ysize, jr.header.xsize
    return jcodec.fused_decode_batch(
        *[jnp.asarray(arrays[a]) for a in ARGS], jr._delta_high,
        jr._delta_low, jnp.asarray(arrays["const_vals"]),
        chunk_len=1 << jr.header.chunk_log2, b=n, h=h, w=w, **static, **kw)


def _port_batch(tr, arrays, static, n, **kw):
    h, w = tr.header.ysize, tr.header.xsize
    return tcodec.fused_decode_batch(
        *[arrays[a] for a in ARGS], tr._delta_high, tr._delta_low,
        arrays["const_vals"], chunk_len=1 << tr.header.chunk_log2, b=n, h=h,
        w=w, **static, **kw)


def test_cases_cover_the_decode_paths(files):
    """The files between them hold every path the decode API takes: CONST
    and RAW planes, a ctx16 low plane, CG2D frames, prev-frame chains and
    coded CG2D previews with the preview delta."""
    seen = set()
    for _frames, _shift, data in files.values():
        for _jr, _tr, _bi, _n, _jpb, tpb in _sections(data):
            _a, st = tcodec.batch_decode_args(tpb, 256)
            seen |= {k for k in ("any_cg", "any_prev", "pv_any_cg",
                                 "any_pv_delta", "low_ctx") if st[k]}
            for name, s in zip(("high", "low", "preview"),
                               (tpb.high, tpb.low, tpb.preview)):
                seen.add((name, s.coding))
    assert {"any_cg", "any_prev", "pv_any_cg", "any_pv_delta",
            "low_ctx"} <= seen
    assert {("high", CODING_CONST), ("low", CODING_RAW),
            ("low", CODING_CTX16), ("preview", CODING_RAW),
            ("preview", 0)} <= seen


@pytest.mark.parametrize("name", list(CASES))
def test_batch_decode_args_equal_jax(files, name):
    _frames, _shift, data = files[name]
    for jr, _tr, _bi, _n, jpb, tpb in _sections(data):
        k = 1 << jr.header.chunk_log2
        assert tcodec.section_rows_need(tpb, k) == jcodec.section_rows_need(
            jpb, k)
        ja, js = jcodec.batch_decode_args(jpb, k)
        ta, ts = tcodec.batch_decode_args(tpb, k)
        assert ts == js
        assert set(ta) == set(ja)
        for key in ja:
            assert ta[key].dtype == ja[key].dtype, key
            _eq(ta[key], ja[key], key)


@pytest.mark.parametrize("name", list(CASES))
def test_fused_decode_batch_equals_jax(files, name):
    """Every section, previews on and off, packed bytes on and off: the
    frames, previews and ok equal JAX's, and the frames are the file's."""
    frames, shift, data = files[name]
    want = frames.astype(np.uint16) << shift
    start = 1  # frame 0 is the delta section
    for jr, tr, _bi, n, jpb, tpb in _sections(data):
        k = 1 << jr.header.chunk_log2
        ja, js = jcodec.batch_decode_args(jpb, k)
        ta, ts = tcodec.batch_decode_args(tpb, k)
        j_full = _jax_batch(jr, ja, js, n, decode_preview=True, pack_u8=True)
        h, w = jr.header.ysize, jr.header.xsize
        imgs = np.asarray(j_full[0]).view("<u2").reshape(n, h, w)
        _eq(imgs, want[start : start + n])
        for pv in (False, True):
            for pack in (False, True):
                got = _port_batch(tr, ta, ts, n, decode_preview=pv,
                                  pack_u8=pack)
                assert len(got) == 2 + pv
                ref = j_full[0] if pack else imgs
                assert got[0].dtype == (torch.uint8 if pack else torch.int32)
                _eq(got[0], ref, f"{name} pv={pv} pack={pack}")
                assert got[1].dtype == torch.bool and got[1].dim() == 0
                assert bool(got[1]) == bool(j_full[1]) is True
                if pv:
                    assert got[2].dtype == torch.uint8
                    _eq(got[2], j_full[2], f"{name} previews")
                if pack:
                    _eq(got[0].numpy().view("<u2").reshape(n, h, w), imgs)
        start += n


def test_fused_decode_batch_takes_tensors_and_flags_a_bad_stream(files):
    """Tensor inputs stay on their device; a corrupted payload word turns
    ``ok`` false on both sides."""
    _frames, _shift, data = files["plasma-order0"]
    jr, tr, _bi, n, jpb, tpb = _sections(data)[0]
    k = 1 << jr.header.chunk_log2
    ta, ts = tcodec.batch_decode_args(tpb, k)
    ja, js = jcodec.batch_decode_args(jpb, k)
    bad = dict(ta)
    bad["payload"] = ta["payload"].copy()
    bad["payload"][int(ta["plane_offs"][0]) + 40] ^= 0x5A5A
    tens = {key: torch.from_numpy(v.copy()) for key, v in bad.items()}
    got = _port_batch(tr, tens, ts, n, decode_preview=True)
    jbad = dict(ja)
    jbad["payload"] = bad["payload"]
    ref = _jax_batch(jr, jbad, js, n, decode_preview=True)
    assert not bool(got[1]) and not bool(ref[1])
    assert got[0].device.type == "cpu"


def test_rows_alloc_override_and_its_floor(files):
    """``rows_alloc`` may raise the window (the sharded decode's common
    shape): the arrays and static equal JAX's and the decode is unchanged;
    below the section's need both raise ValueError."""
    _frames, _shift, data = files["plasma-ctx16"]
    jr, tr, _bi, n, jpb, tpb = _sections(data)[0]
    k = 1 << jr.header.chunk_log2
    need = tcodec.section_rows_need(tpb, k)
    ja, js = jcodec.batch_decode_args(jpb, k, rows_alloc=need + 64)
    ta, ts = tcodec.batch_decode_args(tpb, k, rows_alloc=need + 64)
    assert ts == js and ts["rows_alloc"] == need + 64
    for key in ja:
        _eq(ta[key], ja[key], key)
    base, _s = tcodec.batch_decode_args(tpb, k)
    assert ta["payload"].size > base["payload"].size
    _eq(_port_batch(tr, ta, ts, n)[0], _port_batch(tr, base, _s, n)[0])
    for mod, pb in ((jcodec, jpb), (tcodec, tpb)):
        with pytest.raises(ValueError, match="rows_alloc"):
            mod.batch_decode_args(pb, k, rows_alloc=need - 1)


def test_batch_decode_args_rejects_narrow_sections():
    """The arrays describe 1024-lane streams only: a narrow section (the
    default writer's small-file policy) raises instead of decoding
    garbage."""
    frames = testdata.plasma_frames(4, 32, 64, bits=12)
    data = tcodec.encode_file_fpvt(frames, shift=4, frames_per_batch=3,
                                   chunk_log2=8, device="cpu")
    tr = tcodec.FpvtReader(data, device="cpu")
    pb = tr._parse_batch(tr._batches[0][0])
    assert pb.high.lanes < 1024
    with pytest.raises(ValueError, match="1024-lane"):
        tcodec.batch_decode_args(pb, 256)


def _spy(monkeypatch, name):
    """Record (arguments, result) of every call of jcodec.<name>."""
    calls = []
    real = getattr(jcodec, name)

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(jcodec, name, spy)
    return calls


def _host(x):
    return x if isinstance(x, (bool, int)) else np.asarray(x)


@pytest.mark.parametrize("name,frames_idx", [("plasma-ctx16", (2, 6)),
                                             ("plasma-order0", (1, 2))])
def test_fused_decode_frame_equals_jax(files, name, frames_idx, monkeypatch):
    """The arguments JAX's reader builds for one frame (captured from its
    ``decode_frame``, along prev chains too) give the port's
    ``fused_decode_frame`` JAX's frame and ok; the port's
    ``_frame_decode_args`` builds the same arguments."""
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "pallas")
    _frames, _shift, data = files[name]
    calls = _spy(monkeypatch, "fused_decode_frame")
    jr = jcodec.FpvtReader(data)
    tr = tcodec.FpvtReader(data, device="cpu")
    h, w, k = jr.header.ysize, jr.header.xsize, 1 << jr.header.chunk_log2
    for j in frames_idx:
        calls.clear()
        want = jr.decode_frame(j)
        assert calls
        for args, kw, (ref, ref_ok) in calls:
            img, ok = tcodec.fused_decode_frame(
                *[_host(a) for a in args], device="cpu", **kw)
            assert img.dtype == torch.int32 and img.shape == want.shape
            assert ok.dtype == torch.bool and bool(ok) == bool(ref_ok)
            _eq(img, ref, f"{name} frame {j}")
        _eq(img, want, f"{name} frame {j}")
        bi, jj = tr._frame_to_batch[j]
        mine, mine_kw = tcodec._frame_decode_args(
            tr._parse_batch(tr._batches[bi][0]), jj, h, w, k)
        args, kw, _out = calls[-1]
        assert mine_kw == kw
        for a, b in zip(mine, args[:14]):
            assert a.dtype == np.asarray(b).dtype
            _eq(a, b)


@pytest.mark.parametrize("name", ["plasma-order0", "plasma-ctx16"])
def test_fused_decode_preview_equals_jax(files, name, monkeypatch):
    """The arguments JAX's reader builds for a batch's previews give the
    port's ``fused_decode_preview`` JAX's previews and ok."""
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "pallas")
    _frames, _shift, data = files[name]
    calls = _spy(monkeypatch, "fused_decode_preview")
    jr = jcodec.FpvtReader(data)
    tr = tcodec.FpvtReader(data, device="cpu")
    for bi in range(jr.num_batches):
        calls.clear()
        want = jr.decode_previews(bi)
        _eq(tr.decode_previews(bi), want)
        for args, kw, (ref, ref_ok) in calls:
            pv, ok = tcodec.fused_decode_preview(
                *[_host(a) for a in args], device="cpu", **kw)
            assert pv.dtype == torch.uint8 and bool(ok) == bool(ref_ok)
            _eq(pv, ref, f"{name} batch {bi}")
            mine, mine_kw = tcodec._preview_decode_args(
                tr._parse_batch(tr._batches[bi][0]), tr.header.ysize,
                tr.header.xsize)
            assert mine_kw == kw
            for a, b in zip(mine, args[:6]):
                assert a.dtype == np.asarray(b).dtype
                _eq(a, b)
    if name == "plasma-order0":
        assert calls  # a coded preview stream went through the program


def _stacked(secs):
    """batch_decode_args of sections of one signature, stacked as the
    sharded decode stacks them: JAX's arrays as its ``sharded_decode_file``
    builds them (payloads zero-padded to one length, the hints' union, the
    rows' maximum), the port's by ``mesh.stack_decode_args`` -> (JAX stack,
    JAX static), (port stack, port static)."""
    k = 1 << secs[0][0].header.chunk_log2
    rows = max(jcodec.section_rows_need(s[4], k) for s in secs)
    built = [jcodec.batch_decode_args(s[4], k, rows_alloc=rows) for s in secs]
    plen = max(a["payload"].size for a, _ in built)
    stack = {key: np.stack([np.pad(a[key], (0, plen - a[key].size))
                            if key == "payload" else a[key]
                            for a, _ in built]) for key in built[0][0]}
    static = dict(built[0][1])
    for _a, s in built[1:]:
        for key in ("any_up", "any_cg", "pv_any_up", "pv_any_cg",
                    "any_pv_delta", "any_prev"):
            static[key] |= s[key]
    return (stack, static), tmesh.stack_decode_args([s[5] for s in secs], k)


@pytest.mark.parametrize("previews", [False, True])
def test_sharded_fused_decode_two_cpu_shards(files, previews):
    """Two sections on two logical CPU shards: the stacked outputs equal
    per-section ``fused_decode_batch`` calls and JAX's
    ``sharded_fused_decode`` on a two-device mesh."""
    _frames, _shift, data = files["plasma-ctx16"]
    secs = _sections(data)
    assert len(secs) == 2 and secs[0][3] == secs[1][3]
    jr, tr, _bi, n, _jpb, _tpb = secs[0]
    h, w, k = jr.header.ysize, jr.header.xsize, 1 << jr.header.chunk_log2
    (jstack, jstatic), (tstack, tstatic) = _stacked(secs)
    assert tstatic == jstatic
    for key in jstack:
        _eq(tstack[key], jstack[key], key)
    m = tmesh.make_mesh(2, data=2, devices=[torch.device("cpu")] * 2)
    step = tmesh.sharded_fused_decode(m, chunk_len=k, b=n, h=h, w=w,
                                      decode_preview=previews, **tstatic)
    got = step(*[tstack[a] for a in ARGS], tr._delta_high, tr._delta_low,
               tstack["const_vals"])
    assert len(got) == 2 + previews
    assert got[0].shape == (2, n * h, 2 * w) and got[1].shape == (2,)
    for d in range(2):
        one = tcodec.fused_decode_batch(
            *[tstack[a][d] for a in ARGS], tr._delta_high, tr._delta_low,
            tstack["const_vals"][d], chunk_len=k, b=n, h=h, w=w,
            decode_preview=previews, pack_u8=True, device="cpu", **tstatic)
        for g, o in zip(got, one):
            _eq(g[d], o)
    jm = jmesh.make_mesh(2, data=2)
    jstep = jmesh.sharded_fused_decode(jm, chunk_len=k, b=n, h=h, w=w,
                                       decode_preview=previews, **jstatic)
    ref = jstep(*[jnp.asarray(jstack[a]) for a in ARGS], jr._delta_high,
                jr._delta_low, jnp.asarray(jstack["const_vals"]))
    for g, r in zip(got, ref):
        _eq(g, r)


@pytest.mark.parametrize("seed,chain", [
    pytest.param(seed, chain, id=f"{seed}-chain" if chain else str(seed))
    for chain in (False, True) for seed in (0, 1, 2)])
def test_temporal_inverse_equals_jax(seed, chain):
    """The temporal inverse (one segmented prefix sum over the batch) equals
    JAX's ``_apply_temporal_and_combine`` (a scan over frames) on random
    residuals and random static-delta / prev-frame flags; so does a walk
    of batches of one, each given the frame before as ``prev``, as
    ``decode_frame`` walks a prev chain."""
    from fpv_tpu_torch.format.fpvt import F_USE_DELTA, F_USE_PREV
    from fpv_tpu_torch.ops.planes import combine_planes

    rng = np.random.default_rng(seed)
    b = 9
    hi, lo = (rng.integers(0, 256, (b, 6, 10), dtype=np.uint8)
              for _ in range(2))
    dh, dl = (rng.integers(0, 256, (6, 10), dtype=np.uint8) for _ in range(2))
    flags = ((rng.random(b) < 0.5) * F_USE_DELTA
             | (rng.random(b) < 0.6) * F_USE_PREV).astype(np.int32)
    any_prev = bool((flags & F_USE_PREV).any())
    ref = jcodec._apply_temporal_and_combine(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray((flags & F_USE_DELTA) != 0),
        jnp.asarray((flags & F_USE_PREV) != 0), jnp.asarray(dh),
        jnp.asarray(dl), any_prev=any_prev)
    args = [torch.from_numpy(a) for a in (hi, lo, flags, dh, dl)]
    if not chain:
        got = tcodec._apply_temporal(*args, any_prev)
    else:
        planes, prev = [], None
        for t in range(b):
            one = tcodec._apply_temporal(
                args[0][t : t + 1], args[1][t : t + 1], args[2][t : t + 1],
                args[3], args[4], bool(flags[t] & F_USE_PREV), prev)
            planes.append(one)
            prev = (one[0][0], one[1][0])
        got = [torch.cat([p[i] for p in planes]) for i in (0, 1)]
    _eq(combine_planes(*got), ref)

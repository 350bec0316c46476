"""K2's measurement variants and K1a's nsub: plain versions against JAX.

The port's plain variant decoder (``rans_cuda.rans_decode_variant_ref``)
and K1's plain encoder at other precisions are held to the JAX package's
``decode_pallas``/``encode_pallas`` flags in interpret mode, bit for bit,
at small shapes (1024-lane blocks, chunk 16-32, 2-3 blocks).  The streams
come from the JAX package's own coder and are handed to the port as its
PlaneStream; the card kernels are held to these plain versions by
``test_torch_cuda.py`` and ``chip_smoke.py``.

JAX writes each step's symbol unmasked (``_decode_kernel``'s acc), the
port zero past a lane's length, so symbols are compared on full-length
lanes; ``ok`` on every lane.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpv_tpu.entropy import plane_codec as jpc
from fpv_tpu.entropy.tables import normalize_freqs as jnormalize_freqs
from fpv_tpu.ops import rans_pallas as rp
from fpv_tpu_torch.entropy import plane_codec as tpc
from fpv_tpu_torch.entropy.tables import normalize_freqs
from fpv_tpu_torch.ops import rans_cuda as tc
from fpv_tpu_torch.ops.rans_layout import (
    BLOCK_LANES,
    CODING_CTX16,
    CODING_ORDER0,
    RANS_L,
    chunk_lens,
)

CODINGS = [pytest.param(CODING_ORDER0, id="order0"),
           pytest.param(CODING_CTX16, id="ctx16")]


def _plane(nb: int, k: int, seed: int) -> np.ndarray:
    """rans_bound's synthetic plane (zigzag geometric) of nb*k*1024
    symbols, [1, n] u8."""
    rng = np.random.default_rng(seed)
    vals = rng.geometric(0.35, nb * k * BLOCK_LANES).astype(np.int64) - 1
    return ((-(vals & 1) ^ (vals >> 1)) & 0xFF).astype(np.uint8)[None]


def _streams(coding: int, nb: int = 2, k: int = 32, seed: int = 13):
    """A JAX-coded 1024-lane stream (numpy engine) -> (the JAX decode_pallas
    args and kwargs, the port's K2 DecodePlane of the same stream, the
    symbols).  A short last lane keeps inactive steps in play."""
    plane = _plane(nb, k, seed)[:, :-300]
    if coding == CODING_CTX16:
        plane = plane & 0xF0  # the low plane's bottom nibble is clear
    hist = np.bincount(plane.reshape(-1), minlength=256)
    js = jpc.encode_plane_batch(plane, hist, engine="numpy", chunk_len=k,
                                coding=coding)
    ts = tpc.PlaneStream(
        nframes=js.nframes, plane_size=js.plane_size, chunk_len=js.chunk_len,
        freq=np.asarray(js.freq), states=np.asarray(js.states),
        block_counts=np.asarray(js.block_counts),
        payload=np.asarray(js.payload), coding=js.coding, lanes=js.lanes)
    args, kwargs = jpc.pallas_decode_args(js)
    (plane_t,) = tpc.decode_launch_args(ts, "cpu")
    return args, kwargs, plane_t, js


def _jax_decode(args, kwargs, **flags):
    syms, ok = rp.decode_pallas(*args, **kwargs, **flags)
    nb = np.asarray(ok).shape[0]
    return (np.asarray(syms).reshape(nb, -1, BLOCK_LANES),
            np.asarray(ok).reshape(nb, BLOCK_LANES))


def _assert_equal_on_full_lanes(port, jax_out, lens, k):
    syms, ok = (np.asarray(t) for t in port)
    jsyms, jok = jax_out
    full = np.asarray(lens) == k
    assert full.any() and not full.all()
    np.testing.assert_array_equal(syms.transpose(0, 2, 1)[full],
                                  jsyms.transpose(0, 2, 1)[full])
    np.testing.assert_array_equal(ok, jok)


def test_decode_launch_args_is_the_readers_staging():
    """decode_launch_args hands K2 the plane the reader stages, and the
    production plain decode inverts the stream."""
    _a, _k, plane, js = _streams(CODING_ORDER0)
    syms, ok = tc.rans_decode_ref(*plane)
    assert (ok.numpy() == 1).all()
    want = _plane(2, 32, 13)[:, :-300].reshape(-1)
    np.testing.assert_array_equal(syms.numpy().reshape(-1)[: want.size],
                                  want)
    assert plane.table.numel() == 4096 and not plane.ctx_mode
    const = tpc.const_plane_stream(1, 8, 16, 3)
    with pytest.raises(ValueError, match="coded"):
        tpc.decode_launch_args(const, "cpu")


@pytest.mark.parametrize("stub_tables", [False, True],
                         ids=["window", "tables+window"])
def test_stub_window_plain_equals_jax(stub_tables):
    """stub_window reads no word: the port's plain replica equals JAX's
    (symbols on full-length lanes, ok everywhere), with and without
    stub_tables."""
    args, kwargs, plane, _js = _streams(CODING_ORDER0)
    got = tc.rans_decode_variant_ref(*plane, stub_window=True,
                                     stub_tables=stub_tables)
    want = _jax_decode(args, kwargs, stub_window=True,
                       stub_tables=stub_tables)
    _assert_equal_on_full_lanes(got, want, plane.lens, plane.chunk_len)
    # a replica's output is meaningless, but not the stream's decode
    assert not torch.equal(got[0], tc.rans_decode_ref(*plane)[0])


def _jax_window_words(padded: torch.Tensor):
    """JAX's word read (``_decode_kernel`` :584-606) as a stand-in for
    ``rans_cuda._payload_words``: the 9 rows of 128 words from row
    max(ptr // 128 - 8, 0) of the group's window (the payload from the
    group's start, zero past its end); 0 outside them."""

    def words(pay, base, ptr, total, rank):
        al = torch.clamp((ptr >> 7) - 8, min=0)
        pos = (ptr - total)[:, None] + rank
        rel = (pos >> 7) - al[:, None]
        valid = (rel >= 0) & (rel < 9)
        at = torch.where(valid, base[:, None] + pos, 0)
        return torch.where(valid, padded[at], 0)

    return words


def test_stub_tables_plain_differs_from_jax_only_in_the_window(monkeypatch):
    """stub_tables keeps K2's word read, whose pointers the stand-in
    entries send below their group's words.  There the port reads the
    clamped payload (K2's read) and JAX's window 0 — a divergence by
    design (ROADMAP queue 3).  With JAX's windowed read put in place of
    the port's, the replicas agree bit for bit; with the port's own they
    differ."""
    args, kwargs, plane, _js = _streams(CODING_ORDER0)
    want = _jax_decode(args, kwargs, stub_tables=True)
    own = tc.rans_decode_variant_ref(*plane, stub_tables=True)
    full = plane.lens.numpy() == plane.chunk_len
    assert not np.array_equal(own[0].numpy().transpose(0, 2, 1)[full],
                              want[0].transpose(0, 2, 1)[full])
    pay = plane.payload.to(torch.int64) & 0xFFFF
    padded = torch.cat([pay, pay.new_zeros(1 << 16)])
    monkeypatch.setattr(tc, "_payload_words", _jax_window_words(padded))
    got = tc.rans_decode_variant_ref(*plane, stub_tables=True)
    _assert_equal_on_full_lanes(got, want, plane.lens, plane.chunk_len)


@pytest.mark.parametrize("ncls", [2, 3])
@pytest.mark.parametrize("coding", CODINGS)
def test_stub_class_plain_equals_jax_and_production(coding, ncls):
    """stub_class N on N tiled table copies (JAX's class is the lane's
    column mod N) decodes as K2 does: the port's plain variant equals its
    production plain decode and JAX's stub_class output (port of
    tests/test_rans.py::test_stub_class_tables_bit_exact)."""
    args, kwargs, plane, _js = _streams(coding)
    ref = tc.rans_decode_ref(*plane)
    tiled = plane._replace(table=plane.table.repeat(ncls))
    got = tc.rans_decode_variant_ref(*tiled, stub_class=ncls)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    jtab = jnp.asarray(np.tile(np.asarray(args[3]), (ncls, 1)))
    want = _jax_decode(args[:3] + (jtab,) + args[4:], kwargs,
                       stub_class=ncls)
    _assert_equal_on_full_lanes(got, want, plane.lens, plane.chunk_len)
    # a lane's class is its column's: lanes 2 and 130 share copy 2 of 3
    lane = np.arange(BLOCK_LANES)
    assert ((lane & 127) % 3)[130] == 2 and (lane % 3)[130] == 1


@pytest.mark.parametrize("coding", CODINGS)
def test_two_table_plain_equals_jax(coding):
    """fused_tab=False: the table functions equal JAX's table_arrays /
    ctx_decode_table_arrays, and the two-table plain decode equals JAX's
    and the fused production decode."""
    args, kwargs, plane, js = _streams(coding)
    if coding == CODING_CTX16:
        fc, sym = tc.ctx_decode_table_arrays(js.freq)
        jfc, jsym = rp.ctx_decode_table_arrays(js.freq)
    else:
        fc, sym = tc.two_table_arrays(js.freq)
        jfc, _finv, jsym = rp.table_arrays(js.freq)
    np.testing.assert_array_equal(fc, np.asarray(jfc).reshape(-1))
    np.testing.assert_array_equal(sym, np.asarray(jsym).reshape(-1))
    table = tc.u32_tensor(tc.two_table(fc, sym), "cpu")
    got = tc.rans_decode_variant_ref(*plane._replace(table=table),
                                     fused_tab=False)
    ref = tc.rans_decode_ref(*plane)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    jkw = dict(kwargs, fused_tab=False)
    want = _jax_decode(args[:3] + (jnp.asarray(jsym), jnp.asarray(jfc))
                       + args[5:], jkw)
    _assert_equal_on_full_lanes(got, want, plane.lens, plane.chunk_len)


@pytest.mark.parametrize("pb", [11, 10])
def test_prob_bits_encode_decode_matches_jax(pb):
    """Order-0 at prob_bits 11 and 10: K1's plain encoder equals JAX
    encode_pallas(prob_bits=pb) (states, words, counts), the fused table
    equals JAX's, and the pb variant's plain decode inverts the
    stream exactly."""
    k, nb = 32, 2
    plane = _plane(nb, k, 7).reshape(-1)
    scale = 1 << pb
    hist = np.bincount(plane, minlength=256)
    freq = normalize_freqs(hist, scale=scale, ensure_all=True,
                           floor_mask=hist > 0)
    np.testing.assert_array_equal(
        freq, jnormalize_freqs(hist, scale=scale, ensure_all=True,
                               floor_mask=hist > 0))
    cum = np.zeros(256, np.uint32)
    cum[1:] = np.cumsum(freq)[:-1].astype(np.uint32)
    fc = (((np.maximum(freq, 1) - 1).astype(np.uint32) & (scale - 1))
          | (cum << np.uint32(pb)))
    lens = chunk_lens(1, plane.size, k)
    syms = plane.reshape(nb, k, BLOCK_LANES)
    states, counts, payload = tc.rans_encode_ref(
        torch.from_numpy(syms), torch.from_numpy(lens.reshape(nb, -1)),
        tc.u32_tensor(fc, "cpu"), pb)
    jst, jwords, jcounts = rp.encode_pallas(
        jnp.asarray(syms.reshape(nb, k, 8, 128).astype(np.int32)),
        jnp.asarray(lens.reshape(nb, 8, 128)), jnp.asarray(fc.reshape(2, 128)),
        chunk_len=k, nblocks=nb, prob_bits=pb)
    jcounts = np.asarray(jcounts).reshape(-1)
    np.testing.assert_array_equal(states.numpy().view(np.uint32).reshape(-1),
                                  np.asarray(jst).reshape(-1))
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    jwords = np.asarray(jwords).reshape(len(jcounts), -1)
    jpay = np.concatenate([w[:c] for w, c in zip(jwords, jcounts)])
    np.testing.assert_array_equal(payload.numpy().view(np.uint16), jpay)
    table = tc.fused_table_arrays(freq, prob_bits=pb)
    np.testing.assert_array_equal(
        table, rp.fused_table_arrays(freq, prob_bits=pb).reshape(-1))
    assert table.size == scale
    starts = torch.cumsum(counts.to(torch.int64), 0) - counts
    out, ok = tc.rans_decode_variant(
        [tc.DecodePlane(counts, starts, states,
                        torch.from_numpy(lens.reshape(nb, -1)),
                        tc.u32_tensor(table, "cpu"), payload, k, pb)])[0]
    assert (ok.numpy() == 1).all()
    np.testing.assert_array_equal(out.numpy(), syms)
    with pytest.raises(ValueError, match="sum to 4096"):
        tc.fused_table_arrays(freq)


@pytest.mark.parametrize("nsub", [1, 2, 4, 8])
def test_nsub_is_launch_geometry(nsub):
    """nsub only regroups blocks: JAX's decode_pallas and encode_pallas at
    each nsub (3 blocks, which 2, 4 and 8 do not divide) equal the port's
    production plain decode and encode, which the nsub wrappers run on
    the CPU; the card pads as JAX pads (states RANS_L, lengths 0)."""
    k, nb = 16, 3
    plane = _plane(nb, k, 9)
    hist = np.bincount(plane.reshape(-1), minlength=256)
    js = jpc.encode_plane_batch(plane, hist, engine="numpy", chunk_len=k)
    args, kwargs = jpc.pallas_decode_args(js)
    ts = tpc.PlaneStream(
        nframes=1, plane_size=plane.size, chunk_len=k, freq=js.freq,
        states=js.states, block_counts=js.block_counts, payload=js.payload)
    planes = tpc.decode_launch_args(ts, "cpu")
    got = tc.rans_decode_variant(planes, nsub=nsub)[0]
    ref = tc.rans_decode_ref(*planes[0])
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    want = _jax_decode(args, kwargs, nsub=nsub)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])

    freq = normalize_freqs(hist, ensure_all=True, floor_mask=hist > 0)
    fc = tc.table_arrays(freq)
    lens = chunk_lens(1, plane.size, k)
    syms = plane.reshape(nb, k, BLOCK_LANES)
    enc = tc.rans_encode_chain([tc.EncodePlane(
        torch.from_numpy(syms), torch.from_numpy(lens.reshape(nb, -1)),
        tc.u32_tensor(fc, "cpu"))], nsub=nsub)[0]
    jst, _jw, jcounts = rp.encode_pallas(
        jnp.asarray(syms.reshape(nb, k, 8, 128).astype(np.int32)),
        jnp.asarray(lens.reshape(nb, 8, 128)), jnp.asarray(fc.reshape(2, 128)),
        chunk_len=k, nblocks=nb, nsub=nsub)
    np.testing.assert_array_equal(enc[0].numpy().view(np.uint32).reshape(-1),
                                  np.asarray(jst).reshape(-1))
    np.testing.assert_array_equal(enc[3].numpy(),
                                  np.asarray(jcounts).reshape(-1))
    # the card's padding: whole blocks of length 0 and state RANS_L
    pad = tc._pad_blocks(planes[0].states, -(-nb // nsub) * nsub, RANS_L)
    assert pad.shape[0] % nsub == 0 and (pad[nb:] == RANS_L).all()


def test_variant_wrapper_rejects_what_the_card_lacks():
    """The card has only the instantiated variants; nsub outside
    1/2/4/8 is refused everywhere."""
    assert (False, True, True, 0, 12, True, 1) in tc.VARIANTS
    assert (False, False, True, 0, 12, True, 1) not in tc.VARIANTS
    assert len(tc.VARIANTS) == 18
    plane = _streams(CODING_ORDER0)[2]
    with pytest.raises(ValueError, match="nsub"):
        tc.rans_encode_chain([tc.EncodePlane(
            torch.zeros((1, 16, 64), dtype=torch.uint8),
            torch.zeros((1, 64), dtype=torch.int32),
            torch.zeros(256, dtype=torch.int32))], nsub=3)
    out = tc.rans_decode_variant([plane], stub_window=True)[0]
    assert out[0].shape == (2, 32, BLOCK_LANES)


def test_stub_tables_replica_leaves_its_group(monkeypatch):
    """Why the stub_tables replica times no lookup on the card: on the
    reports' plane (2 blocks here) its stand-in entries renormalise more
    often than the stream's, so its pointer passes its group's first word
    before the chunk ends and its later reads fall outside the staged
    words; the stream's own decode never does."""
    from fpv_tpu_torch.ops import rans_bound

    planes, _n = rans_bound._build_args(2, device="cpu")
    orig = tc._payload_words
    seen = {}

    def count(flags):
        stats = seen.setdefault(flags, {"renorms": 0, "steps": 0,
                                        "first_below": None})

        def words(pay, base, ptr, total, rank):
            if stats["first_below"] is None and bool((ptr - total < 0).any()):
                stats["first_below"] = stats["steps"]
            stats["renorms"] += int(total.sum())
            stats["steps"] += 1
            return orig(pay, base, ptr, total, rank)

        return words

    for flags in (False, True):
        monkeypatch.setattr(tc, "_payload_words", count(flags))
        tc.rans_decode_variant_ref(*planes[0], stub_tables=flags)
    stream, replica = seen[False], seen[True]
    assert stream["first_below"] is None
    assert replica["renorms"] > stream["renorms"]
    assert 0 < replica["first_below"] < planes[0].chunk_len

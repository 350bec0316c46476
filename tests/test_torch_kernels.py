"""fpv_tpu_torch kernels' plain versions against the JAX package's oracles.

K1/K2 (rANS encode/decode) are held to ``fpv_tpu.ops.rans_numpy`` and to
the Pallas kernels in interpret mode; K3 (CG2D wavefront inverse) to the
XLA scan oracle ``fpv_tpu.ops.predict._cg2d_decode_impl``.  Inputs are made
from seeded numpy generators and handed to both sides; every comparison is
exact (the codec is integer and lossless).  The CUDA kernels themselves are
held to these plain versions on the card by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpv_tpu.entropy.tables import normalize_freqs, normalize_freqs_ctx
from fpv_tpu.ops import predict as jpredict
from fpv_tpu.ops import rans_numpy as rn
from fpv_tpu.ops import rans_pallas as rp
from fpv_tpu_torch.ops import predict as tpredict
from fpv_tpu_torch.ops import rans_cuda as tc
from fpv_tpu_torch.ops.rans_layout import (
    BLOCK_LANES,
    CTX_PROB_BITS,
    SEG_LEN,
    chunk_lens,
    num_segments,
)

LANES = BLOCK_LANES


def _block_syms(n: int, k: int, seed: int, ctx: bool, lanes: int = LANES):
    """A skewed symbol stream of n symbols in the [nblocks, K, lanes] block
    layout (zero-padded) plus its lane lengths."""
    rng = np.random.default_rng(seed)
    hi = 16 if ctx else 256
    flat = np.minimum(rng.geometric(0.3, n) - 1, hi - 1).astype(np.uint8)
    lens = chunk_lens(1, n, k, lanes)
    nb = len(lens) // lanes
    pad = np.zeros(nb * k * lanes, np.uint8)
    pad[:n] = flat
    return pad.reshape(nb, k, lanes), lens


def _oracle_layout(syms: np.ndarray) -> np.ndarray:
    """[nb, K, lanes] block layout -> rans_numpy's [C_pad, K] lane rows."""
    nb, k, lanes = syms.shape
    return syms.transpose(0, 2, 1).reshape(nb * lanes, k)


def _starts(counts: np.ndarray) -> np.ndarray:
    out = np.zeros(len(counts), np.int64)
    out[1:] = np.cumsum(counts.astype(np.int64))[:-1]
    return out


def _oracle_encode(syms, lens, ctx):
    """rans_numpy encode + the tables both coders use."""
    rows = _oracle_layout(syms)
    lanes = syms.shape[2]
    if ctx:
        idx = rn.encode_ctx_indices(rows.astype(np.int32), lens, lanes)
        jhist = np.bincount(idx.reshape(-1), minlength=512)
        freq = normalize_freqs_ctx(jhist, floor_mask=jhist > 0)
        _f, cum, _s = rn.ctx_tables(freq)
        enc = rn.encode_blocks(idx, lens, freq, prob_bits=CTX_PROB_BITS,
                               cum=cum, lanes=lanes)
        return freq, enc, tc.ctx_table_arrays(freq)
    hist = np.bincount(rows.reshape(-1), minlength=256)
    freq = normalize_freqs(hist, ensure_all=True)
    return (freq, rn.encode_blocks(rows, lens, freq, lanes=lanes),
            tc.table_arrays(freq))


def _torch_encode(syms, lens, fc, ctx):
    return tc.rans_encode_ref(
        torch.from_numpy(syms),
        torch.from_numpy(lens.reshape(-1, syms.shape[2])),
        torch.from_numpy(fc.astype(np.uint32).view(np.int32)),
        prob_bits=CTX_PROB_BITS if ctx else 12,
        ctx_mode=ctx,
    )


def _torch_decode(states, counts, payload, lens, freq, k, ctx, lanes=LANES):
    table = (tc.ctx_fused_table_arrays(freq) if ctx
             else tc.fused_table_arrays(freq))
    counts = np.asarray(counts, np.int64)
    syms, ok = tc.rans_decode_ref(
        torch.from_numpy(counts.astype(np.int32)),
        torch.from_numpy(_starts(counts)),
        torch.from_numpy(np.asarray(states, np.uint32).view(np.int32)
                         .reshape(-1, lanes)),
        torch.from_numpy(lens.reshape(-1, lanes)),
        torch.from_numpy(table.view(np.int32)),
        torch.from_numpy(np.asarray(payload, np.uint16).view(np.int16)),
        k,
        prob_bits=CTX_PROB_BITS if ctx else 12,
        ctx_mode=ctx,
    )
    return syms.numpy(), ok.numpy()


# chunk 256: one segment; chunk 1024: two segments (state carry).  The
# k256 cases end in a block with zero-length pad lanes, the k1024 cases in
# a short block whose last segment is partly empty.  The narrow cases
# (lanes 8-512, the JAX package's host-engine geometry) run chunks from 16
# to 2048 steps (four segments), with and without pad lanes.
CASES = [
    pytest.param(256, 2 * 256 * LANES + 700, False, LANES, True,
                 id="order0-k256-pad"),
    pytest.param(1024, 1024 * LANES + 300_001, False, LANES, False,
                 id="order0-k1024"),
    pytest.param(256, 256 * LANES + 513, True, LANES, True,
                 id="ctx16-k256-pad"),
    pytest.param(1024, 1024 * LANES + 123_457, True, LANES, False,
                 id="ctx16-k1024"),
    pytest.param(16, 2 * 16 * 8 + 5, False, 8, True, id="lanes8-order0-k16-pad"),
    pytest.param(1024, 6144, True, 8, False, id="lanes8-ctx16-k1024"),
    pytest.param(2048, 2048 * 32 - 77, True, 32, False,
                 id="lanes32-ctx16-k2048"),
    pytest.param(512, 512 * 128 + 100, True, 128, True,
                 id="lanes128-ctx16-k512-pad"),
    pytest.param(64, 3 * 64 * 512 - 9, False, 512, False,
                 id="lanes512-order0-k64"),
]


@pytest.mark.parametrize("k,n,ctx,lanes,pad", CASES)
def test_plain_rans_encode_matches_numpy_oracle(k, n, ctx, lanes, pad):
    syms, lens = _block_syms(n, k, seed=k + ctx, ctx=ctx, lanes=lanes)
    assert (lens == 0).any() == pad
    _freq, (st, cnt, pay), fc = _oracle_encode(syms, lens, ctx)
    states, counts, payload = _torch_encode(syms, lens, fc, ctx)
    assert counts.numel() == len(lens) // lanes * num_segments(k)
    np.testing.assert_array_equal(states.numpy().view(np.uint32).reshape(-1),
                                  st)
    np.testing.assert_array_equal(counts.numpy(), cnt)
    np.testing.assert_array_equal(payload.numpy().view(np.uint16), pay)


@pytest.mark.parametrize("k,n,ctx,lanes,pad", CASES)
def test_plain_rans_decode_matches_numpy_oracle(k, n, ctx, lanes, pad):
    syms, lens = _block_syms(n, k, seed=k + ctx + 7, ctx=ctx, lanes=lanes)
    freq, (st, cnt, pay), _fc = _oracle_encode(syms, lens, ctx)
    oracle = rn.decode_blocks_ctx if ctx else rn.decode_blocks
    ref_syms, ref_ok = oracle(st, cnt, pay, lens, freq, k, lanes=lanes)
    assert ref_ok.all()
    got, ok = _torch_decode(st, cnt, pay, lens, freq, k, ctx, lanes)
    np.testing.assert_array_equal(_oracle_layout(got), ref_syms)
    np.testing.assert_array_equal(got, syms)
    np.testing.assert_array_equal(ok.reshape(-1).astype(bool), ref_ok)

    # corrupted payload: the ok flags must report it exactly as the oracle
    bad = pay.copy()
    bad[len(bad) // 3] ^= 0x5A5A
    ref_syms, ref_ok = oracle(st, cnt, bad, lens, freq, k, lanes=lanes)
    got, ok = _torch_decode(st, cnt, bad, lens, freq, k, ctx, lanes)
    assert not ref_ok.all()
    np.testing.assert_array_equal(ok.reshape(-1).astype(bool), ref_ok)
    np.testing.assert_array_equal(_oracle_layout(got), ref_syms)


def test_plain_rans_matches_pallas_interpret():
    """Order-0 at chunk_len 16 against the Pallas kernels (interpret mode):
    final states, per-(block, segment) counts, compacted payload, decoded
    symbols and ok flags."""
    k = 16
    syms, lens = _block_syms(LANES * k + 5000, k, seed=3, ctx=False)
    nb = syms.shape[0]
    hist = np.bincount(syms.reshape(-1), minlength=256)
    freq = normalize_freqs(hist, ensure_all=True)
    fc = tc.table_arrays(freq)
    j_st, j_words, j_cnt = rp.encode_pallas(
        jnp.asarray(syms.reshape(nb, k, 8, 128).astype(np.int32)),
        jnp.asarray(lens.reshape(nb, 8, 128)),
        jnp.asarray(fc.reshape(2, 128)),
        k, nb, interpret=True,
    )
    j_cnt = np.asarray(j_cnt).reshape(-1)
    j_words = np.asarray(j_words).reshape(len(j_cnt), -1)
    j_pay = np.concatenate([w[:c] for w, c in zip(j_words, j_cnt)])
    states, counts, payload = _torch_encode(syms, lens, fc, False)
    np.testing.assert_array_equal(
        states.numpy().view(np.uint32), np.asarray(j_st).reshape(nb, LANES)
    )
    np.testing.assert_array_equal(counts.numpy(), j_cnt)
    np.testing.assert_array_equal(payload.numpy().view(np.uint16), j_pay)

    rows = -(-int(j_cnt.max()) // 128) + 16
    words = np.zeros((len(j_cnt), rows * 128), np.uint32)
    for g, (w, c) in enumerate(zip(j_words, j_cnt)):
        words[g, :c] = w[:c]
    j_syms, j_ok = rp.decode_pallas(
        jnp.asarray(j_cnt.reshape(-1, 1, 1).astype(np.int32)),
        jnp.asarray(np.asarray(j_st)),
        jnp.asarray(lens.reshape(nb, 8, 128)),
        jnp.asarray(rp.fused_table_arrays(freq)),
        jnp.zeros((2, 128), jnp.uint32),
        jnp.asarray(words.reshape(len(j_cnt), rows, 128)),
        k, nb, interpret=True, fused_tab=True,
    )
    got, ok = _torch_decode(
        states.numpy().view(np.uint32), j_cnt, j_pay, lens, freq, k, False
    )
    active = np.arange(k)[None, :, None] < lens.reshape(nb, 1, LANES)
    np.testing.assert_array_equal(
        got[active], np.asarray(j_syms).reshape(nb, k, LANES)[active]
    )
    np.testing.assert_array_equal(ok, np.asarray(j_ok).reshape(nb, LANES))
    np.testing.assert_array_equal(got, syms)


def test_segment_layout_constants():
    assert SEG_LEN == 512
    assert num_segments(4096) == 8 and num_segments(512) == 1


# the shape classes of the Pallas wavefront test: tiny, non-multiple-of-128,
# multi-tile H, degenerate 1-row/1-col, multi-batch
CG2D_SHAPES = [
    (2, 8, 8), (1, 16, 12), (3, 12, 36), (2, 130, 140), (1, 1, 7),
    (1, 7, 1), (3, 12, 260), (2, 256, 128), (5, 33, 20),
]


@pytest.mark.parametrize("shape", CG2D_SHAPES, ids=str)
def test_plain_cg2d_decode_matches_scan_oracle(shape):
    rng = np.random.default_rng(sum(shape))
    plane = rng.integers(0, 256, shape, np.int64).astype(np.uint8)
    res = np.array(jpredict.cg2d_encode(plane))
    ref = np.asarray(jpredict._cg2d_decode_impl(jnp.asarray(res)))
    got = tpredict.cg2d_decode(torch.from_numpy(res)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, plane)


def _cg2d_case(shape):
    """A seeded u8 plane and its JAX CG2D residual."""
    rng = np.random.default_rng(sum(shape) + 1)
    plane = rng.integers(0, 256, shape, np.int64).astype(np.uint8)
    return plane, np.array(jpredict.cg2d_encode(plane))


# K3's row groups: one row per group, groups that split a warp, one warp,
# and the kernel's 1024; plus last groups that are partial
GROUP_CASES = [
    pytest.param(shape, g, id=f"{shape}-g{g}")
    for g in (1, 3, 32, 1024) for shape in CG2D_SHAPES
] + [pytest.param(shape, 32, id=f"{shape}-g32-partial")
     for shape in ((1, 70, 9), (2, 65, 33))]


@pytest.mark.parametrize("shape,group_rows", GROUP_CASES)
def test_plain_cg2d_row_groups_match_scan_oracle(shape, group_rows):
    """The plain version walks K3's schedule (row groups in order, one
    step per anti-diagonal of a group); every group size gives the scan
    oracle's result exactly."""
    plane, res = _cg2d_case(shape)
    ref = np.asarray(jpredict._cg2d_decode_impl(jnp.asarray(res)))
    got = tpredict.cg2d_decode_ref(torch.from_numpy(res),
                                   group_rows=group_rows).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, plane)


def test_plain_cg2d_matches_pallas_interpret():
    """The plain version on row groups of 32 against the TPU wavefront
    kernel in interpret mode, on a shape with a partial last group."""
    plane, res = _cg2d_case((2, 40, 20))
    ref = np.asarray(jpredict._cg2d_decode_pallas(res, interpret=True))
    got = tpredict.cg2d_decode_ref(torch.from_numpy(res), group_rows=32)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, plane)


# K1's two passes: lanes 8 to 1024, chunks 16 to 4096 (one to eight
# segments), with zero-length pad lanes where the stream ends mid-block
PASS_CASES = [
    pytest.param(16, 3 * 16 * 8 + 5, False, 8, id="lanes8-order0-k16"),
    pytest.param(4096, 4096 * 32 - 100, True, 32, id="lanes32-ctx16-k4096"),
    pytest.param(512, 2 * 512 * 128 + 77, False, 128,
                 id="lanes128-order0-k512"),
    pytest.param(64, 2 * 64 * 512 - 3, True, 512, id="lanes512-ctx16-k64"),
    pytest.param(4096, 4096 * LANES - 5000, False, LANES,
                 id="lanes1024-order0-k4096"),
    pytest.param(16, 16 * LANES + 9, True, LANES, id="lanes1024-ctx16-k16"),
]


@pytest.mark.parametrize("k,n,ctx,lanes", PASS_CASES)
def test_plain_rans_passes_match_numpy_oracle(k, n, ctx, lanes):
    """rans_encode_chain_ref then rans_place_ref (K1a's and K1b's plain
    versions) equal rans_encode_ref and the rans_numpy oracle bit for bit;
    the ballots carry exactly the emitted words."""
    syms, lens = _block_syms(n, k, seed=k + lanes + ctx, ctx=ctx,
                             lanes=lanes)
    _freq, (st, cnt, pay), fc = _oracle_encode(syms, lens, ctx)
    t_syms = torch.from_numpy(syms)
    t_lens = torch.from_numpy(lens.reshape(-1, lanes))
    t_fc = torch.from_numpy(fc.astype(np.uint32).view(np.int32))
    pb = CTX_PROB_BITS if ctx else 12
    states, words, ballots, counts = tc.rans_encode_chain_ref(
        t_syms, t_lens, t_fc, pb, ctx)
    assert ballots.shape == (syms.shape[0], k, -(-lanes // 32))
    payload = tc.rans_place_ref(words, ballots)
    np.testing.assert_array_equal(states.numpy().view(np.uint32).reshape(-1),
                                  st)
    np.testing.assert_array_equal(counts.numpy(), cnt)
    np.testing.assert_array_equal(payload.numpy().view(np.uint16), pay)
    assert int(counts.sum()) == sum(bin(b).count("1") for b in
                                    ballots.numpy().view(np.uint32).ravel())
    for got, want in zip((states, counts, payload),
                         tc.rans_encode_ref(t_syms, t_lens, t_fc, pb, ctx)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_encode_reciprocal_is_exact():
    """K1a's reciprocal division: for every frequency of both alphabets
    (1..4096; ctx16 uses 1..128), (x * rcp) >> (32 + shift) == x // f at
    the boundary values and at 10^4 seeded x < 2^31 (x - 1 for f = 1, which
    the kernel's bias makes up for)."""
    rng = np.random.default_rng(11)
    seeded = rng.integers(0, 1 << 31, 10_000, dtype=np.uint64)
    top = np.uint64((1 << 31) - 1)
    f_all = np.arange(1, 4097, dtype=np.uint64)
    rcp, shift = tc.encode_reciprocal(f_all)
    for f, r, s in zip(f_all, rcp.astype(np.uint64), shift.astype(np.uint64)):
        mult = top // f * f
        edges = np.array([1, 2, f - 1, f, f + 1, 2 * f - 1, 2 * f, 1 << 15,
                          (1 << 19) - 1, 1 << 19, (1 << 24) - 1, 1 << 24,
                          mult - 1, mult, top - 1, top], dtype=np.uint64)
        x = np.concatenate([seeded, edges[edges >= 1]])
        q = (x * r) >> (np.uint64(32) + s)
        want = x // f if f > 1 else x - np.uint64(1)
        np.testing.assert_array_equal(q, want, err_msg=f"f={f}")


def test_grouped_wrappers_on_cpu_equal_per_plane_calls():
    """rans_encode_grouped / rans_decode_grouped on the CPU run the plain
    versions plane by plane: the same results as the plain versions called
    per plane, for planes of different chunk lengths, lane counts, codings
    and zero-length lanes."""
    shapes = [(256, 2 * 256 * LANES + 700, False, LANES),
              (128, 6144 - 5, True, 8), (64, 3 * 64 * 512 - 9, True, 512)]
    planes, tables = [], []
    for k, n, ctx, lanes in shapes:
        syms, lens = _block_syms(n, k, seed=n % 13, ctx=ctx, lanes=lanes)
        freq, _enc, fc = _oracle_encode(syms, lens, ctx)
        planes.append(tc.EncodePlane(
            torch.from_numpy(syms), torch.from_numpy(lens.reshape(-1, lanes)),
            torch.from_numpy(fc.astype(np.uint32).view(np.int32)),
            CTX_PROB_BITS if ctx else 12, ctx))
        tables.append(tc.ctx_fused_table_arrays(freq) if ctx
                      else tc.fused_table_arrays(freq))
    grouped = tc.rans_encode_grouped(planes)
    dec = []
    for p, table, got in zip(planes, tables, grouped):
        for g, w in zip(got, tc.rans_encode_ref(*p)):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        states, counts, payload = got
        starts = torch.cumsum(counts.to(torch.int64), 0) - counts
        dec.append(tc.DecodePlane(
            counts, starts, states, p.lens,
            torch.from_numpy(table.view(np.int32)), payload,
            p.syms.shape[1], p.prob_bits, p.ctx_mode))
    for p, d, (g_syms, g_ok) in zip(planes, dec,
                                    tc.rans_decode_grouped(dec)):
        w_syms, w_ok = tc.rans_decode_ref(*d)
        np.testing.assert_array_equal(g_syms.numpy(), w_syms.numpy())
        np.testing.assert_array_equal(g_ok.numpy(), w_ok.numpy())
        np.testing.assert_array_equal(g_syms.numpy(), p.syms.numpy())


@pytest.mark.parametrize("wrapper", ["encode_chain", "encode_place",
                                     "decode"])
def test_grouped_wrappers_refuse_planes_on_two_devices(wrapper):
    """A grouped call whose planes lie on different devices raises instead
    of running the plain version on the second plane's device (a meta
    tensor stands in for a card's)."""
    syms, lens = _block_syms(300, 16, seed=3, ctx=False, lanes=8)
    plane = tc.EncodePlane(torch.from_numpy(syms),
                           torch.from_numpy(lens.reshape(-1, 8)),
                           torch.zeros(256, dtype=torch.int32))
    chain = tc.rans_encode_chain([plane])[0]
    states, counts = chain[0], chain[3]
    dec = tc.DecodePlane(counts, torch.cumsum(counts.to(torch.int64), 0),
                         states, plane.lens,
                         torch.zeros(4096, dtype=torch.int32),
                         torch.zeros(0, dtype=torch.int16), 16)

    def meta(p):
        return type(p)(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                         for a in p))

    calls = {"encode_chain": (tc.rans_encode_chain, plane),
             "encode_place": (tc.rans_encode_place, tuple(chain[1:])),
             "decode": (tc.rans_decode_grouped, dec)}
    fn, first = calls[wrapper]
    second = (tuple(a.to("meta") for a in first) if wrapper == "encode_place"
              else meta(first))
    with pytest.raises(ValueError, match="one device"):
        fn([first, second])


def test_staged_payload_pads_and_aligns():
    """staged_payload returns a payload already staged as is, else the same
    words at a 16-byte aligned start, readable to a multiple of 1024 words;
    an empty payload gets a buffer too."""
    buf = torch.arange(3000, dtype=torch.int16)
    for pay in (buf[1:2500], buf[8:8], torch.zeros(0, dtype=torch.int16)):
        staged = tc.staged_payload(pay)
        assert tc.is_staged(staged)
        torch.testing.assert_close(staged, pay, rtol=0, atol=0)
    padded = torch.zeros(2 * tc.PAYLOAD_PAD, dtype=torch.int16)[:1500]
    assert tc.is_staged(padded) and tc.staged_payload(padded) is padded

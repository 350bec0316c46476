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

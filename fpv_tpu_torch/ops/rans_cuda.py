"""Block-interleaved rANS coder: CUDA kernels K1/K2, plain versions, tables.

The PyTorch counterpart of ``fpv_tpu/ops/rans_pallas.py``.  The stream
layout is ``rans_layout``'s, bit for bit.

* :func:`rans_encode` launches K1 (``csrc/rans_encode.cu``) on CUDA
  tensors; :func:`rans_encode_ref` is its plain PyTorch version.
* :func:`rans_decode` launches K2 (``csrc/rans_decode.cu``, fused-table
  lookups only); :func:`rans_decode_ref` is its plain version.

Each wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.

Tensors carry unsigned values in signed dtypes: u32 states and table
entries as int32 (same bits), u16 payload words as int16.  Symbols are
uint8 ``[nblocks, K, 1024]`` (step-major, lane = row-major [8, 128]).
"""

from __future__ import annotations

import numpy as np
import torch

from fpv_tpu_torch.entropy.tables import ctx_tables
from fpv_tpu_torch.ops.planes import to_int16
from fpv_tpu_torch.ops.rans_layout import (
    BLOCK_LANES,
    CTX_ALPHA,
    CTX_PROB_BITS,
    CTX_PROB_SCALE,
    PROB_BITS,
    RANS_L,
    SEG_LEN,
)
from fpv_tpu_torch.utils import kernels

_U32 = 0xFFFFFFFF


def u32_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy u32 -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def _segments(chunk_len: int) -> tuple[int, int]:
    """(kseg, nseg) of a stream's chunk length."""
    if chunk_len < 1 or chunk_len & (chunk_len - 1):
        raise ValueError(f"chunk_len must be a power of two, got {chunk_len}")
    kseg = min(chunk_len, SEG_LEN)
    return kseg, chunk_len // kseg


# ---------------------------------------------------------------------------
# host table builders (numpy)


def table_arrays(freq: np.ndarray) -> np.ndarray:
    """Order-0 ENCODE table: [256] u32 fc = (f-1) | cum << 12."""
    freq = np.asarray(freq, dtype=np.uint32)
    cum = np.zeros(256, dtype=np.uint32)
    cum[1:] = np.cumsum(freq)[:-1]
    return ((np.maximum(freq, 1) - 1) & 0xFFF) | (cum << PROB_BITS)


def fused_table_arrays(freq: np.ndarray) -> np.ndarray:
    """Order-0 DECODE table, one u32 entry per slot: [4096].

    entry = off << 20 | (f-1) << 8 | sym, with off = slot - cum[sym]."""
    freq = np.asarray(freq, dtype=np.uint32)
    if int(freq.sum()) != 1 << PROB_BITS:
        raise ValueError("frequency table does not sum to 4096")
    cum = np.zeros(256, dtype=np.uint32)
    cum[1:] = np.cumsum(freq)[:-1]
    sym_of_slot = np.repeat(
        np.arange(256, dtype=np.uint32), freq.astype(np.int64)
    )
    slots = np.arange(1 << PROB_BITS, dtype=np.uint32)
    off = slots - cum[sym_of_slot]
    f1 = freq[sym_of_slot] - 1
    return (
        (off << np.uint32(8 + PROB_BITS)) | (f1 << np.uint32(8)) | sym_of_slot
    )


def ctx_table_arrays(freq_ctx: np.ndarray) -> np.ndarray:
    """Ctx16 ENCODE table: [512] u32 fc = (f-1) | cum_within_ctx << 7."""
    freq32, cum, _sos = ctx_tables(freq_ctx)
    return ((np.maximum(freq32, 1) - 1) & ((1 << CTX_PROB_BITS) - 1)) | (
        cum << CTX_PROB_BITS
    )


def ctx_fused_table_arrays(freq_ctx: np.ndarray) -> np.ndarray:
    """Ctx16 DECODE table, one u32 entry per (ctx, slot): [4096].

    Index ctx * 128 + slot; entry = off << 11 | (f-1) << 4 | sym."""
    freq32, cum, sym_of_slot = ctx_tables(freq_ctx)
    n = len(sym_of_slot)  # CTX_NCTX * 128 = 4096
    idx = np.arange(n, dtype=np.uint32)
    sym = sym_of_slot.astype(np.uint32)
    pair = (idx >> CTX_PROB_BITS) * CTX_ALPHA + sym
    f1 = freq32[pair].astype(np.uint32) - 1
    off = (idx & (CTX_PROB_SCALE - 1)) - cum[pair].astype(np.uint32)
    return (off << np.uint32(11)) | (f1 << np.uint32(4)) | sym


# ---------------------------------------------------------------------------
# K1: encode


def _ctx_of(prev: torch.Tensor) -> torch.Tensor:
    """ctx = a*2 + (al != ar) of [nblocks, 1024] previous-step symbols,
    neighbors wrapping within each block's lanes."""
    al = torch.roll(prev, 1, dims=1)
    ar = torch.roll(prev, -1, dims=1)
    return prev * 2 + (al != ar).to(prev.dtype)


def rans_encode_ref(
    syms: torch.Tensor,
    lens: torch.Tensor,
    fc: torch.Tensor,
    prob_bits: int = PROB_BITS,
    ctx_mode: bool = False,
):
    """Plain PyTorch K1: a vectorized loop over symbol steps (reverse).

    ``syms`` u8 [nblocks, K, 1024] (nibbles in ctx mode, zero beyond each
    lane's length), ``lens`` i32 [nblocks, 1024], ``fc`` i32 encode table.
    Returns (states i32 [nblocks, 1024], counts i32 [nblocks*nseg],
    payload i16 [sum(counts)])."""
    nb, k, lanes = syms.shape
    kseg, nseg = _segments(k)
    dev = syms.device
    tab = fc.to(torch.int64) & _U32
    fmask = (1 << prob_bits) - 1
    lens64 = lens.to(torch.int64)
    x = torch.full((nb, lanes), RANS_L, dtype=torch.int64, device=dev)
    words = torch.zeros((k, nb, lanes), dtype=torch.int64, device=dev)
    emits = torch.zeros((k, nb, lanes), dtype=torch.bool, device=dev)
    for j in range(k - 1, -1, -1):
        idx = syms[:, j].to(torch.int64)
        if ctx_mode and j:
            idx = _ctx_of(syms[:, j - 1].to(torch.int64)) * CTX_ALPHA + idx
        e = tab[idx]
        f = (e & fmask) + 1
        active = j < lens64
        emit = active & (x >= (f << (31 - prob_bits)))
        words[j] = x & 0xFFFF
        emits[j] = emit
        x2 = torch.where(emit, x >> 16, x)
        q = x2 // f
        xn = (q << prob_bits) + (x2 - q * f) + (e >> prob_bits)
        x = torch.where(active, xn, x)
    # payload: per block, segments ascending; steps descending; lanes asc
    order = (2, 0, 1, 3)
    w = words.view(nseg, kseg, nb, lanes).permute(order).flip(2)
    e = emits.view(nseg, kseg, nb, lanes).permute(order).flip(2)
    counts = e.sum(dim=(2, 3)).reshape(-1).to(torch.int32)
    return x.to(torch.int32), counts, to_int16(w[e])


def rans_encode(
    syms: torch.Tensor,
    lens: torch.Tensor,
    fc: torch.Tensor,
    prob_bits: int = PROB_BITS,
    ctx_mode: bool = False,
):
    """K1 on CUDA tensors (see :func:`rans_encode_ref` for the contract)."""
    if syms.device.type == "cpu":
        return rans_encode_ref(syms, lens, fc, prob_bits, ctx_mode)
    kernels.check_cuda(syms, torch.uint8, "syms")
    kernels.check_cuda(lens, torch.int32, "lens")
    kernels.check_cuda(fc, torch.int32, "fc")
    nb, k, lanes = syms.shape
    kseg, nseg = _segments(k)
    if lanes != BLOCK_LANES or lens.shape != (nb, BLOCK_LANES):
        raise ValueError("rans_encode takes 1024-lane blocks")
    if fc.numel() != (512 if ctx_mode else 256):
        raise ValueError("encode table has the wrong size for the mode")
    dev = syms.device
    states = torch.empty((nb, BLOCK_LANES), dtype=torch.int32, device=dev)
    region = kseg * BLOCK_LANES
    words = torch.empty((nb * nseg, region), dtype=torch.int16, device=dev)
    counts = torch.empty(nb * nseg, dtype=torch.int32, device=dev)
    kernels.launch(
        "rans_encode", "fpvt_rans_encode", dev,
        syms.data_ptr(), lens.data_ptr(), fc.data_ptr(), fc.numel(), nb, k,
        prob_bits, int(ctx_mode), states.data_ptr(), words.data_ptr(),
        counts.data_ptr(),
    )
    # compact the worst-case (block, segment) regions into one tight stream
    valid = torch.arange(region, device=dev)[None, :] < counts[:, None]
    return states, counts, words[valid]


# ---------------------------------------------------------------------------
# K2: decode


def rans_decode_ref(
    counts: torch.Tensor,
    starts: torch.Tensor,
    states: torch.Tensor,
    lens: torch.Tensor,
    table: torch.Tensor,
    payload: torch.Tensor,
    chunk_len: int,
    prob_bits: int = PROB_BITS,
    ctx_mode: bool = False,
):
    """Plain PyTorch K2: a vectorized loop over symbol steps.

    ``counts`` i32 / ``starts`` i64 [nblocks*nseg] word count and payload
    offset of each (block, segment) group; ``states``/``lens`` i32
    [nblocks, 1024]; ``table`` i32 [4096] fused decode entries;
    ``payload`` i16 [T] words.  Returns (syms u8 [nblocks, K, 1024] — zero
    beyond each lane's length, nibbles in ctx mode — and ok i32
    [nblocks, 1024])."""
    nb, lanes = states.shape
    k = chunk_len
    kseg, nseg = _segments(k)
    dev = states.device
    sym_bits = 4 if ctx_mode else 8
    fmask = (1 << prob_bits) - 1
    tab = table.to(torch.int64) & _U32
    pay = payload.to(torch.int64) & 0xFFFF
    total_words = pay.numel()
    cnt = counts.to(torch.int64).view(nb, nseg)
    st = starts.to(torch.int64).view(nb, nseg)
    lens64 = lens.to(torch.int64)
    x = states.to(torch.int64) & _U32
    out = torch.zeros((nb, k, lanes), dtype=torch.uint8, device=dev)
    prev = torch.zeros((nb, lanes), dtype=torch.int64, device=dev)
    seg_ok = torch.ones(nb, dtype=torch.bool, device=dev)
    ptr = base = None
    for j in range(k):
        if j % kseg == 0:
            if j:
                seg_ok &= ptr == 0
            ptr = cnt[:, j // kseg].clone()
            base = st[:, j // kseg]
        active = j < lens64
        idx = x & fmask
        if ctx_mode:
            idx = idx + (_ctx_of(prev) << prob_bits)
        e = tab[idx]
        sym = e & ((1 << sym_bits) - 1)
        f = ((e >> sym_bits) & fmask) + 1
        xn = f * (x >> prob_bits) + (e >> (sym_bits + prob_bits))
        renorm = active & (xn < RANS_L)
        r = renorm.to(torch.int64)
        total = r.sum(dim=1)
        pos = (base + ptr - total)[:, None] + torch.cumsum(r, dim=1) - r
        if total_words:
            w = pay[pos.clamp(0, total_words - 1)]
        else:
            w = torch.zeros_like(pos)
        xn = torch.where(renorm, (xn << 16) | w, xn)
        x = torch.where(active, xn, x)
        ptr = ptr - total
        prev = torch.where(active, sym, 0)
        out[:, j] = prev.to(torch.uint8)
    seg_ok &= ptr == 0
    ok = ((x == RANS_L) & seg_ok[:, None]) | (lens64 == 0)
    return out, ok.to(torch.int32)


def rans_decode(
    counts: torch.Tensor,
    starts: torch.Tensor,
    states: torch.Tensor,
    lens: torch.Tensor,
    table: torch.Tensor,
    payload: torch.Tensor,
    chunk_len: int,
    prob_bits: int = PROB_BITS,
    ctx_mode: bool = False,
):
    """K2 on CUDA tensors (see :func:`rans_decode_ref` for the contract)."""
    if states.device.type == "cpu":
        return rans_decode_ref(counts, starts, states, lens, table, payload,
                               chunk_len, prob_bits, ctx_mode)
    kernels.check_cuda(counts, torch.int32, "counts")
    kernels.check_cuda(starts, torch.int64, "starts")
    kernels.check_cuda(states, torch.int32, "states")
    kernels.check_cuda(lens, torch.int32, "lens")
    kernels.check_cuda(table, torch.int32, "table")
    kernels.check_cuda(payload, torch.int16, "payload")
    nb, lanes = states.shape
    _kseg, nseg = _segments(chunk_len)
    if lanes != BLOCK_LANES or lens.shape != (nb, BLOCK_LANES):
        raise ValueError("rans_decode takes 1024-lane blocks")
    if counts.numel() != nb * nseg or starts.numel() != nb * nseg:
        raise ValueError("one count and start per (block, segment) needed")
    if table.numel() != 1 << PROB_BITS:
        raise ValueError("fused decode table must have 4096 entries")
    dev = states.device
    out = torch.empty((nb, chunk_len, BLOCK_LANES), dtype=torch.uint8,
                      device=dev)
    ok = torch.empty((nb, BLOCK_LANES), dtype=torch.int32, device=dev)
    kernels.launch(
        "rans_decode", "fpvt_rans_decode", dev,
        counts.data_ptr(), starts.data_ptr(), states.data_ptr(),
        lens.data_ptr(), table.data_ptr(), payload.data_ptr(),
        payload.numel(), nb, chunk_len, prob_bits, int(ctx_mode),
        out.data_ptr(), ok.data_ptr(),
    )
    return out, ok

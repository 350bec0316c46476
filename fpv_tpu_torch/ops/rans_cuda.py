"""Block-interleaved rANS coder: CUDA kernels K1/K2, plain versions, tables.

The PyTorch counterpart of ``fpv_tpu/ops/rans_pallas.py``.  The stream
layout is ``rans_layout``'s, bit for bit.

* K1 (``csrc/rans_encode.cu``) runs in two passes, each one launch for a
  list of planes: :func:`rans_encode_chain` (K1a: every lane's state
  chain -> states, per-step words and emit ballots, per-group counts) and
  :func:`rans_encode_place` (K1b: words + ballots -> the tight payload).
  Their plain versions are :func:`rans_encode_chain_ref` and
  :func:`rans_place_ref`.  :func:`rans_encode_grouped` runs both passes,
  :func:`rans_encode_ref` both plain versions.
* :func:`rans_decode_grouped` launches K2 (``csrc/rans_decode.cu``,
  fused-table lookups only) once for a list of planes;
  :func:`rans_decode_ref` is its plain version.

Each wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.  The planes of one call must
lie on one device (else ValueError).

Tensors carry unsigned values in signed dtypes: u32 states, table entries
and ballots as int32 (same bits), u16 words as int16.  Symbols are uint8
``[nblocks, K, lanes]`` (step-major); ``lanes`` is 1024 (the device
geometry, lane = row-major [8, 128]) or a narrow stream's power of two
from LANES_MIN to 512.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fpv_tpu_torch.entropy.tables import ctx_tables
from fpv_tpu_torch.ops.planes import to_int16
from fpv_tpu_torch.ops.rans_layout import (
    BLOCK_LANES,
    CTX_ALPHA,
    CTX_PROB_BITS,
    CTX_PROB_SCALE,
    LANES_MIN,
    PROB_BITS,
    RANS_L,
    SEG_LEN,
)
from fpv_tpu_torch.utils import kernels

_U32 = 0xFFFFFFFF

# Plane descriptors of the grouped launches: int64 rows, in the field order
# of csrc/rans_encode.cu EncDesc and csrc/rans_decode.cu DecDesc.
ENC_FIELDS = ("syms", "lens", "fc", "states", "words", "ballots", "counts",
              "starts", "nidx", "nblocks", "lanes", "chunk_len", "prob_bits",
              "ctx_mode", "cta0", "grp0")
DEC_FIELDS = ("counts", "starts", "states", "lens", "table", "payload",
              "out", "ok", "total_words", "nblocks", "lanes", "chunk_len",
              "prob_bits", "ctx_mode", "cta0")
CHAIN_THREADS = 128  # K1a threads per CTA (rans_encode.cu kChainThreads)
CHAIN_AHEAD = 16  # K1a's symbol rows in flight: the least chunk_len (kAhead)
MAX_PLANES = 8  # planes per grouped launch (kMaxPlanes in both sources)
# K2 stages the payload in 16-byte copies of whole chunks of up to 1024
# words: a plane's payload starts 16-byte aligned and stays readable up to
# a multiple of PAYLOAD_PAD words past its start.
PAYLOAD_ALIGN = 8
PAYLOAD_PAD = 1024


def u32_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy u32 -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def _check_lanes(lanes: int) -> None:
    if not LANES_MIN <= lanes <= BLOCK_LANES or lanes & (lanes - 1):
        raise ValueError(
            f"lanes must be a power of two in [{LANES_MIN}, {BLOCK_LANES}], "
            f"got {lanes}"
        )


def _segments(chunk_len: int) -> tuple[int, int]:
    """(kseg, nseg) of a stream's chunk length."""
    if chunk_len < 1 or chunk_len & (chunk_len - 1):
        raise ValueError(f"chunk_len must be a power of two, got {chunk_len}")
    kseg = min(chunk_len, SEG_LEN)
    return kseg, chunk_len // kseg


def _one_device(tensors) -> torch.device:
    """The device all ``tensors`` lie on; ValueError when they differ, so a
    call never runs a plain version on a CUDA tensor."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError("the planes of one call must lie on one device, got "
                         + ", ".join(sorted(map(str, devs))))
    return devs.pop()


def _descriptors(rows: list[dict], fields: tuple) -> np.ndarray:
    """Plane descriptors as an int64 host array; the C entry passes them to
    the kernel by value (at most MAX_PLANES)."""
    if not 1 <= len(rows) <= MAX_PLANES:
        raise ValueError(f"a grouped launch takes 1 to {MAX_PLANES} planes")
    return np.array([[r[f] for f in fields] for r in rows], dtype=np.int64)


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


class EncodePlane(NamedTuple):
    """K1's inputs for one plane: ``syms`` u8 [nblocks, K, lanes] (nibbles
    in ctx mode, zero beyond each lane's length), ``lens`` i32
    [nblocks, lanes], ``fc`` i32 encode table."""

    syms: torch.Tensor
    lens: torch.Tensor
    fc: torch.Tensor
    prob_bits: int = PROB_BITS
    ctx_mode: bool = False


def num_ballot_words(lanes: int) -> int:
    """u32 emit-ballot words per (block, step): one per warp of lanes."""
    return -(-lanes // 32)


def _pack_ballots(emits: torch.Tensor) -> torch.Tensor:
    """bool [nb, K, lanes] -> i32 [nb, K, num_ballot_words] bit masks (bit
    i of word w is lane 32*w + i)."""
    nb, k, lanes = emits.shape
    e = emits.to(torch.int64)
    if lanes < 32:
        e = torch.cat([e, e.new_zeros((nb, k, 32 - lanes))], dim=2)
    bit = torch.arange(32, dtype=torch.int64, device=e.device)
    words = (e.view(nb, k, num_ballot_words(lanes), 32) << bit).sum(dim=3)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def _unpack_ballots(ballots: torch.Tensor, lanes: int) -> torch.Tensor:
    """Inverse of :func:`_pack_ballots` -> bool [nb, K, lanes]."""
    nb, k, nwb = ballots.shape
    bit = torch.arange(32, dtype=torch.int64, device=ballots.device)
    bits = ((ballots.to(torch.int64) & _U32)[..., None] >> bit) & 1
    return bits.reshape(nb, k, nwb * 32)[..., :lanes].to(torch.bool)


def encode_reciprocal(f: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """K1a's exact reciprocals (csrc/rans_encode.cu make_coder): per
    frequency f, (rcp, shift) with ``(x * rcp) >> (32 + shift) == x // f``
    for every x < 2^31 and f >= 2 (Alverson's method); f = 1 gives
    ``x - 1``, which the kernel's bias makes up for."""
    f = np.asarray(f, dtype=np.uint64)
    ceil_log2 = np.array([int(v - 1).bit_length() for v in f.tolist()],
                         dtype=np.uint64)
    one = f == 1
    rcp = ((np.uint64(1) << (ceil_log2 + np.uint64(31))) + f - np.uint64(1)
           ) // np.maximum(f, np.uint64(1))
    rcp = np.where(one, np.uint64(0xFFFFFFFF), rcp)
    shift = np.where(one, np.uint64(0), ceil_log2 - np.uint64(1))
    return rcp.astype(np.uint32), shift.astype(np.uint32)


def _ctx_of(prev: torch.Tensor) -> torch.Tensor:
    """ctx = a*2 + (al != ar) of [nblocks, lanes] previous-step symbols,
    neighbors wrapping within each block's lanes."""
    al = torch.roll(prev, 1, dims=1)
    ar = torch.roll(prev, -1, dims=1)
    return prev * 2 + (al != ar).to(prev.dtype)


def rans_encode_chain_ref(
    syms: torch.Tensor,
    lens: torch.Tensor,
    fc: torch.Tensor,
    prob_bits: int = PROB_BITS,
    ctx_mode: bool = False,
):
    """Plain PyTorch K1a: a vectorized loop over symbol steps (reverse).

    Inputs as :class:`EncodePlane`.  Returns (states i32 [nblocks, lanes];
    words i16 [nblocks, K, lanes], each step's ``x & 0xFFFF`` before its
    update, emitted or not; ballots i32 [nblocks, K, num_ballot_words],
    the emit bits; counts i32 [nblocks*nseg], the words emitted per
    (block, segment))."""
    nb, k, lanes = syms.shape
    kseg, nseg = _segments(k)
    dev = syms.device
    tab = fc.to(torch.int64) & _U32
    fmask = (1 << prob_bits) - 1
    lens64 = lens.to(torch.int64)
    x = torch.full((nb, lanes), RANS_L, dtype=torch.int64, device=dev)
    # steps past every lane's length leave x at RANS_L and emit nothing
    jmax = min(k, int(lens64.max())) if lens64.numel() else 0
    words = torch.full((nb, k, lanes), RANS_L & 0xFFFF, dtype=torch.int64,
                       device=dev)
    emits = torch.zeros((nb, k, lanes), dtype=torch.bool, device=dev)
    for j in range(jmax - 1, -1, -1):
        idx = syms[:, j].to(torch.int64)
        if ctx_mode and j:
            idx = _ctx_of(syms[:, j - 1].to(torch.int64)) * CTX_ALPHA + idx
        e = tab[idx]
        f = (e & fmask) + 1
        active = j < lens64
        emit = active & (x >= (f << (31 - prob_bits)))
        words[:, j] = x & 0xFFFF
        emits[:, j] = emit
        x2 = torch.where(emit, x >> 16, x)
        q = x2 // f
        xn = (q << prob_bits) + (x2 - q * f) + (e >> prob_bits)
        x = torch.where(active, xn, x)
    counts = emits.view(nb, nseg, kseg, lanes).sum(dim=(2, 3))
    return (x.to(torch.int32), to_int16(words), _pack_ballots(emits),
            counts.reshape(-1).to(torch.int32))


def rans_place_ref(words: torch.Tensor, ballots: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1b: K1a's words + emit ballots -> the tight payload
    i16 [sum(counts)]: per block, segments ascending; within a segment
    steps descending; within a step lanes ascending."""
    nb, k, lanes = words.shape
    kseg, nseg = _segments(k)
    emits = _unpack_ballots(ballots, lanes)
    w = words.view(nb, nseg, kseg, lanes).flip(2)
    e = emits.view(nb, nseg, kseg, lanes).flip(2)
    return w[e]


def rans_encode_ref(
    syms: torch.Tensor,
    lens: torch.Tensor,
    fc: torch.Tensor,
    prob_bits: int = PROB_BITS,
    ctx_mode: bool = False,
):
    """Plain PyTorch K1: :func:`rans_encode_chain_ref`, then
    :func:`rans_place_ref`.  Returns (states i32 [nblocks, lanes], counts
    i32 [nblocks*nseg], payload i16 [sum(counts)])."""
    states, words, ballots, counts = rans_encode_chain_ref(
        syms, lens, fc, prob_bits, ctx_mode)
    return states, counts, rans_place_ref(words, ballots)


def _check_encode_plane(p: EncodePlane) -> None:
    kernels.check_cuda(p.syms, torch.uint8, "syms")
    kernels.check_cuda(p.lens, torch.int32, "lens")
    kernels.check_cuda(p.fc, torch.int32, "fc")
    nb, k, lanes = p.syms.shape
    _segments(k)
    if k < CHAIN_AHEAD:
        raise ValueError(f"K1 needs chunk_len >= {CHAIN_AHEAD}, got {k}")
    _check_lanes(lanes)
    if p.lens.shape != (nb, lanes):
        raise ValueError("lens must be [nblocks, lanes]")
    if p.fc.numel() != (512 if p.ctx_mode else 256):
        raise ValueError("encode table has the wrong size for the mode")


def rans_encode_chain(planes: list[EncodePlane]) -> list[tuple]:
    """K1a on a list of planes, one launch -> per plane (states, words,
    ballots, counts) as :func:`rans_encode_chain_ref` returns them (on the
    card, words of steps that emit nothing are written too)."""
    dev = _one_device(t for p in planes for t in p[:3])
    if dev.type == "cpu":
        return [rans_encode_chain_ref(*p) for p in planes]
    rows, outs, cta = [], [], 0
    for p in planes:
        _check_encode_plane(p)
        nb, k, lanes = p.syms.shape
        _kseg, nseg = _segments(k)
        out = (
            torch.empty((nb, lanes), dtype=torch.int32, device=dev),
            torch.empty((nb, k, lanes), dtype=torch.int16, device=dev),
            torch.empty((nb, k, num_ballot_words(lanes)), dtype=torch.int32,
                        device=dev),
            torch.zeros(nb * nseg, dtype=torch.int32, device=dev),
        )
        rows.append(dict(
            syms=p.syms.data_ptr(), lens=p.lens.data_ptr(),
            fc=p.fc.data_ptr(), states=out[0].data_ptr(),
            words=out[1].data_ptr(), ballots=out[2].data_ptr(),
            counts=out[3].data_ptr(), starts=0, nidx=p.fc.numel(),
            nblocks=nb, lanes=lanes, chunk_len=k, prob_bits=p.prob_bits,
            ctx_mode=int(p.ctx_mode), cta0=cta, grp0=0,
        ))
        outs.append(out)
        cta += -(-nb * lanes // CHAIN_THREADS)
    descs = _descriptors(rows, ENC_FIELDS)
    kernels.launch("rans_encode_chain", "fpvt_rans_encode_chain", dev,
                   descs.ctypes.data, len(rows), cta)
    return outs


def rans_encode_place(chains: list[tuple]) -> list[torch.Tensor]:
    """K1b on a list of K1a results (words, ballots, counts), one launch ->
    per plane its payload i16 [sum(counts)]: views of one buffer, planes
    in order.  The counts come to the host after the launch, to cut the
    views."""
    dev = _one_device(t for c in chains for t in c)
    if dev.type == "cpu":
        return [rans_place_ref(w, b) for w, b, _c in chains]
    for words, ballots, counts in chains:
        kernels.check_cuda(words, torch.int16, "words")
        kernels.check_cuda(ballots, torch.int32, "ballots")
        kernels.check_cuda(counts, torch.int32, "counts")
        nb, k, lanes = words.shape
        _kseg, nseg = _segments(k)
        _check_lanes(lanes)
        if ballots.shape != (nb, k, num_ballot_words(lanes)):
            raise ValueError("ballots must be [nblocks, K, ceil(lanes/32)]")
        if counts.numel() != nb * nseg:
            raise ValueError("one count per (block, segment) needed")
    counts_all = torch.cat([c for _w, _b, c in chains]).to(torch.int64)
    starts = torch.cumsum(counts_all, 0) - counts_all
    groups = np.cumsum([0] + [c.numel() for _w, _b, c in chains])
    # at most one word per symbol step of a lane: the words buffers' size
    # bounds the payload, so the launch needs no counts on the host
    payload = torch.empty(sum(w.numel() for w, _b, _c in chains),
                          dtype=torch.int16, device=dev)
    rows = []
    for (words, ballots, _c), g0 in zip(chains, groups):
        nb, k, lanes = words.shape
        rows.append(dict(
            syms=0, lens=0, fc=0, states=0, words=words.data_ptr(),
            ballots=ballots.data_ptr(), counts=0,
            starts=starts[g0:].data_ptr(), nidx=0, nblocks=nb, lanes=lanes,
            chunk_len=k, prob_bits=0, ctx_mode=0, cta0=0, grp0=int(g0),
        ))
    descs = _descriptors(rows, ENC_FIELDS)
    kernels.launch("rans_encode_place", "fpvt_rans_encode_place", dev,
                   descs.ctypes.data, len(rows), int(groups[-1]),
                   payload.data_ptr())
    ends = np.cumsum(counts_all.cpu().numpy())
    bounds = [0] + [int(ends[g - 1]) for g in groups[1:]]
    return [payload[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def rans_encode_grouped(planes: list[EncodePlane]) -> list[tuple]:
    """K1 on a list of planes: one K1a and one K1b launch -> per plane
    (states i32 [nblocks, lanes], counts i32 [nblocks*nseg], payload i16
    [sum(counts)]), as :func:`rans_encode_ref` returns them."""
    chains = rans_encode_chain(planes)
    payloads = rans_encode_place([c[1:] for c in chains])
    return [(c[0], c[3], p) for c, p in zip(chains, payloads)]


# ---------------------------------------------------------------------------
# K2: decode


class DecodePlane(NamedTuple):
    """K2's inputs for one plane: ``counts`` i32 / ``starts`` i64
    [nblocks*nseg] word count and payload offset of each (block, segment)
    group; ``states``/``lens`` i32 [nblocks, lanes]; ``table`` i32 [4096]
    fused decode entries; ``payload`` i16 [T] words."""

    counts: torch.Tensor
    starts: torch.Tensor
    states: torch.Tensor
    lens: torch.Tensor
    table: torch.Tensor
    payload: torch.Tensor
    chunk_len: int
    prob_bits: int = PROB_BITS
    ctx_mode: bool = False


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

    Inputs as :class:`DecodePlane`.  Returns (syms u8 [nblocks, K, lanes]
    — zero beyond each lane's length, nibbles in ctx mode — and ok i32
    [nblocks, lanes])."""
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
    # past every lane's length a step changes nothing: only the segment
    # boundaries' checks remain
    jmax = int(lens64.max()) if lens64.numel() else 0
    for j in range(k):
        if j >= jmax and j % kseg:
            continue
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


def is_staged(payload: torch.Tensor) -> bool:
    """Whether K2 may stage ``payload``: 16-byte aligned and readable up to
    a multiple of PAYLOAD_PAD words past its start."""
    need = -(-max(payload.numel(), 1) // PAYLOAD_PAD) * PAYLOAD_PAD
    storage = payload.untyped_storage()
    avail = (storage.data_ptr() + storage.nbytes() - payload.data_ptr()) // 2
    return payload.data_ptr() % 16 == 0 and avail >= need


def staged_payload(payload: torch.Tensor) -> torch.Tensor:
    """``payload`` laid out as K2 stages it: the same words in a padded
    buffer (a view of its first ``numel`` words), or ``payload`` itself
    when it already is (:func:`is_staged`).  The reader builds such
    buffers itself; callers with a payload of their own use this."""
    if is_staged(payload):
        return payload
    n = payload.numel()
    buf = payload.new_zeros(-(-max(n, 1) // PAYLOAD_PAD) * PAYLOAD_PAD)
    buf[:n] = payload
    return buf[:n]


def _check_decode_plane(p: DecodePlane) -> None:
    kernels.check_cuda(p.counts, torch.int32, "counts")
    kernels.check_cuda(p.starts, torch.int64, "starts")
    kernels.check_cuda(p.states, torch.int32, "states")
    kernels.check_cuda(p.lens, torch.int32, "lens")
    kernels.check_cuda(p.table, torch.int32, "table")
    kernels.check_cuda(p.payload, torch.int16, "payload")
    nb, lanes = p.states.shape
    _kseg, nseg = _segments(p.chunk_len)
    _check_lanes(lanes)
    if p.lens.shape != (nb, lanes):
        raise ValueError("lens must be [nblocks, lanes]")
    if p.counts.numel() != nb * nseg or p.starts.numel() != nb * nseg:
        raise ValueError("one count and start per (block, segment) needed")
    if p.table.numel() != 1 << PROB_BITS:
        raise ValueError("fused decode table must have 4096 entries")
    if p.table.data_ptr() % 16:
        raise ValueError("the fused decode table must be 16-byte aligned")
    if p.prob_bits != (CTX_PROB_BITS if p.ctx_mode else PROB_BITS):
        raise ValueError("the fused tables fix prob_bits: 12, or 7 in ctx "
                         "mode")
    if p.payload.numel() >= 1 << 31:
        raise ValueError("a plane's payload must have fewer than 2^31 words")
    if not is_staged(p.payload):
        raise ValueError("the payload must be 16-byte aligned and readable "
                         f"to a multiple of {PAYLOAD_PAD} words past its "
                         "start (see staged_payload)")


def rans_decode_grouped(planes: list[DecodePlane]) -> list[tuple]:
    """K2 on a list of planes, one launch (one CTA per rANS block of each)
    -> per plane (syms, ok) as :func:`rans_decode_ref` returns them."""
    dev = _one_device(t for p in planes for t in p[:6])
    if dev.type == "cpu":
        return [rans_decode_ref(*p) for p in planes]
    rows, outs, cta = [], [], 0
    for p in planes:
        _check_decode_plane(p)
        nb, lanes = p.states.shape
        out = (
            torch.empty((nb, p.chunk_len, lanes), dtype=torch.uint8,
                        device=dev),
            torch.empty((nb, lanes), dtype=torch.int32, device=dev),
        )
        rows.append(dict(
            counts=p.counts.data_ptr(), starts=p.starts.data_ptr(),
            states=p.states.data_ptr(), lens=p.lens.data_ptr(),
            table=p.table.data_ptr(), payload=p.payload.data_ptr(),
            out=out[0].data_ptr(), ok=out[1].data_ptr(),
            total_words=p.payload.numel(), nblocks=nb, lanes=lanes,
            chunk_len=p.chunk_len, prob_bits=p.prob_bits,
            ctx_mode=int(p.ctx_mode), cta0=cta,
        ))
        outs.append(out)
        cta += nb
    descs = _descriptors(rows, DEC_FIELDS)
    threads = max(r["lanes"] for r in rows)  # a thread per lane
    kernels.launch("rans_decode", "fpvt_rans_decode", dev, descs.ctypes.data,
                   len(rows), cta, threads)
    return outs

"""Per-plane-batch rANS stream codec: host packaging + device coding.

One ``PlaneStream`` holds the entropy-coded bytes of one byte plane across a
whole batch of frames, sharing a single frequency table, in the
block-interleaved layout of ``fpv_tpu_torch.ops.rans_layout``.  The coding
itself runs through ``ops.rans_cuda`` (K1/K2 on CUDA tensors, their plain
versions on CPU tensors); this package codes 1024-lane streams only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fpv_tpu_torch.entropy.tables import normalize_freqs, normalize_freqs_ctx
from fpv_tpu_torch.ops import rans_cuda
from fpv_tpu_torch.ops.rans_layout import (
    BLOCK_LANES,
    CODING_CONST,
    CODING_CTX16,
    CODING_ORDER0,
    CODING_RAW,
    CTX_ALPHA,
    CTX_NIDX,
    CTX_PROB_BITS,
    PROB_BITS,
    chunk_lens,
    num_blocks,
)


@dataclasses.dataclass
class PlaneStream:
    """Entropy-coded plane batch (host representation, maps 1:1 to container)."""

    nframes: int
    plane_size: int  # S = bytes per frame plane
    chunk_len: int  # K
    freq: np.ndarray  # [256] u16 (coding=0) or [512] per-ctx u16 (coding=1)
    states: np.ndarray  # [C] u32, one per chunk (pad chunks included)
    block_counts: np.ndarray  # [nblocks * nseg] u32, (block, segment) groups
    payload: np.ndarray  # [sum(block_counts)] u16
    coding: int = CODING_ORDER0
    lanes: int = BLOCK_LANES  # chunks (= parallel rANS streams) per block

    @property
    def num_blocks(self) -> int:
        if self.lanes == 0:  # CONST/RAW streams carry no chunk structure
            return 0
        return num_blocks(
            self.nframes, self.plane_size, self.chunk_len, self.lanes
        )

    @property
    def num_chunks(self) -> int:
        return self.num_blocks * self.lanes

    @property
    def value(self) -> int:
        """The constant byte of a CODING_CONST stream."""
        return int(self.freq[0])

    @property
    def raw_bytes(self) -> np.ndarray:
        """The stored bytes of a CODING_RAW stream (u8, [nframes*plane_size])."""
        n = self.nframes * self.plane_size
        return self.payload.view(np.uint8)[:n]


def raw_plane_stream(
    nframes: int, plane_size: int, chunk_len: int, data: np.ndarray
) -> PlaneStream:
    """A CODING_RAW stream: the plane-batch residual bytes stored verbatim
    (packed little-endian into the u16 payload array; odd sizes pad one
    byte that never serializes)."""
    b = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    if b.size != nframes * plane_size:
        raise ValueError("raw plane data size mismatch")
    if b.size % 2:
        b = np.concatenate([b, np.zeros(1, np.uint8)])
    return PlaneStream(
        nframes=nframes,
        plane_size=plane_size,
        chunk_len=chunk_len,
        freq=np.zeros(0, np.uint16),
        states=np.zeros(0, np.uint32),
        block_counts=np.zeros(0, np.uint32),
        payload=b.view("<u2"),
        coding=CODING_RAW,
        lanes=0,
    )


def const_plane_stream(
    nframes: int, plane_size: int, chunk_len: int, value: int
) -> PlaneStream:
    """A CODING_CONST stream: the whole plane batch is the byte ``value``."""
    return PlaneStream(
        nframes=nframes,
        plane_size=plane_size,
        chunk_len=chunk_len,
        freq=np.array([value], np.uint16),
        states=np.zeros(0, np.uint32),
        block_counts=np.zeros(0, np.uint32),
        payload=np.zeros(0, np.uint16),
        coding=CODING_CONST,
    )


def raw_stream_bytes(n: int) -> int:
    """Serialized size of a CODING_RAW stream of n plane-batch bytes."""
    size = 24 + n
    return size + (-size) % 8


def coded_stream_bytes(num_chunks: int, num_groups: int, total_words: int) -> int:
    """Serialized size of an order-0/ctx16 rANS stream (twin of
    format.fpvt.serialize_plane_stream's layout), so the raw-vs-coded
    decision needs no byte string of either."""
    size = 24 + 512 + 4 * num_chunks + 4 * num_groups + 2 * total_words
    return size + (-size) % 8


# ---------------------------------------------------------------------------
# device-side layout shuffles


def _to_block_symbols(plane: torch.Tensor, chunk_len: int, nblocks: int):
    """[B, S] u8 -> [nblocks, K, 1024] u8 — a pure reshape (zero-padded).

    With the interleaved lane layout (rans_layout.chunk_lens), the
    step-major array IS the flat symbol stream."""
    flat = plane.reshape(-1)
    pad = nblocks * chunk_len * BLOCK_LANES - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(nblocks, chunk_len, BLOCK_LANES)


def _from_block_symbols(
    syms: torch.Tensor, nframes: int, plane_size: int
) -> torch.Tensor:
    """[nblocks, K, 1024] u8 -> [B, S] u8 (pure reshape)."""
    return syms.reshape(-1)[: nframes * plane_size].reshape(
        nframes, plane_size
    )


def ctx_combine_device(prev: torch.Tensor, sym4: torch.Tensor) -> torch.Tensor:
    """(previous-step symbols, symbols) [nb, K', 1024] -> int64 fc indices
    ctx*16+sym (ctx feature defined in rans_layout)."""
    p = prev.to(torch.int64)
    al = torch.roll(p, 1, dims=2)
    ar = torch.roll(p, -1, dims=2)
    ctx = p * 2 + (al != ar).to(torch.int64)
    return ctx * CTX_ALPHA + sym4.to(torch.int64)


def ctx_indices_device(sym4: torch.Tensor) -> torch.Tensor:
    """[nb, K, 1024] nibble symbols (zero-padded) -> fc indices ctx*16+sym."""
    prev = torch.cat([torch.zeros_like(sym4[:, :1]), sym4[:, :-1]], dim=1)
    return ctx_combine_device(prev, sym4)


def ctx_presence_device(sym4: torch.Tensor) -> torch.Tensor:
    """[512] 0/1 int32: exact presence of (ctx, sym) pairs over ALL symbol
    positions (padding included — an exact-support superset)."""
    idx = ctx_indices_device(sym4).reshape(-1)
    return (_hist_flat(idx, CTX_NIDX) > 0).to(torch.int32)


def _hist_flat(x: torch.Tensor, nbins: int) -> torch.Tensor:
    """Exact int64 histogram of a flat int array with values in [0, nbins)."""
    return torch.bincount(x.reshape(-1).to(torch.int64), minlength=nbins)


def lens_tensor(nframes: int, plane_size: int, chunk_len: int, device):
    """Lane lengths [nblocks, 1024] int32 of a plane batch's 1024-lane
    stream (rans_layout.chunk_lens)."""
    lens = chunk_lens(nframes, plane_size, chunk_len)
    return torch.from_numpy(lens.reshape(-1, BLOCK_LANES)).to(device)


def code_blocks(
    plane: torch.Tensor,
    syms: torch.Tensor,
    lens: torch.Tensor,
    fc: torch.Tensor,
    freq: np.ndarray,
    coding: int,
) -> PlaneStream:
    """K1 on block symbols, then the CODING_RAW policy: the [B, S] residual
    ``plane`` is stored verbatim whenever that is not larger than the coded
    stream (ties go to raw — same bytes, no decode kernel).  The sizes come
    from the counts alone, so a losing payload is never serialized."""
    b, s = plane.shape
    k = syms.shape[1]
    ctx = coding == CODING_CTX16
    states, counts, payload = rans_cuda.rans_encode(
        syms, lens, fc, CTX_PROB_BITS if ctx else PROB_BITS, ctx
    )
    coded = coded_stream_bytes(lens.numel(), counts.numel(), payload.numel())
    if raw_stream_bytes(b * s) <= coded:
        return raw_plane_stream(b, s, k, plane.cpu().numpy())
    return PlaneStream(
        nframes=b, plane_size=s, chunk_len=k,
        freq=np.asarray(freq).astype(np.uint16),
        states=states.reshape(-1).cpu().numpy().view(np.uint32),
        block_counts=counts.cpu().numpy().astype(np.uint32),
        payload=payload.cpu().numpy().view(np.uint16),
        coding=coding,
    )


def encode_plane_batch(
    plane: torch.Tensor,
    hist: np.ndarray | None,
    chunk_len: int,
    coding: int = CODING_ORDER0,
    mask: np.ndarray | None = None,
) -> PlaneStream:
    """Encode a [B, S] (or [B, H, W]) uint8 plane batch with host tables,
    applying the CODING_RAW policy.

    ``hist`` is the 256-bin (order-0) histogram, ``mask`` an optional
    exact-support superset (tables.normalize_freqs floor_mask).  With
    ``coding=CODING_CTX16`` (nibble alphabet + conditional tables) the joint
    (ctx, sym) histogram is computed here over the whole block array
    (padding included) and ``hist`` is ignored.
    """
    b = plane.shape[0]
    plane = plane.reshape(b, -1)
    lens = lens_tensor(b, plane.shape[1], chunk_len, plane.device)
    nblocks = lens.shape[0]
    if coding == CODING_CTX16:
        syms = _to_block_symbols(plane >> 4, chunk_len, nblocks)
        jhist = _hist_flat(ctx_indices_device(syms), CTX_NIDX).cpu().numpy()
        freq = normalize_freqs_ctx(jhist, floor_mask=jhist > 0)
        fc = rans_cuda.ctx_table_arrays(freq)
    else:
        freq = normalize_freqs(np.asarray(hist), ensure_all=True,
                               floor_mask=mask)
        syms = _to_block_symbols(plane, chunk_len, nblocks)
        fc = rans_cuda.table_arrays(freq)
    fc = rans_cuda.u32_tensor(fc, plane.device)
    return code_blocks(plane, syms, lens, fc, freq, coding)


def decode_plane_batch(
    stream: PlaneStream, device, name: str = "plane"
) -> torch.Tensor:
    """Decode a PlaneStream -> [B, S] uint8 tensor on ``device``; raises
    ValueError when the rANS integrity check fails and NotImplementedError
    (naming the stream ``name``) for a narrow stream."""
    b, s, k = stream.nframes, stream.plane_size, stream.chunk_len
    if stream.coding == CODING_CONST:
        return torch.full((b, s), stream.value, dtype=torch.uint8,
                          device=device)
    if stream.coding == CODING_RAW:
        return torch.from_numpy(stream.raw_bytes.reshape(b, s).copy()).to(
            device
        )
    if stream.lanes != BLOCK_LANES:
        raise NotImplementedError(
            f"{name} stream is a narrow stream ({stream.lanes} lanes); "
            "only 1024-lane streams are decoded by fpv_tpu_torch so far"
        )
    ctx = stream.coding == CODING_CTX16
    counts = stream.block_counts.astype(np.int64)
    starts = np.zeros(len(counts), np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    table = (rans_cuda.ctx_fused_table_arrays(stream.freq) if ctx
             else rans_cuda.fused_table_arrays(stream.freq))
    syms, ok = rans_cuda.rans_decode(
        torch.from_numpy(counts.astype(np.int32)).to(device),
        torch.from_numpy(starts).to(device),
        rans_cuda.u32_tensor(stream.states, device).reshape(-1, BLOCK_LANES),
        lens_tensor(b, s, k, device),
        rans_cuda.u32_tensor(table, device),
        torch.from_numpy(
            np.ascontiguousarray(stream.payload, np.uint16).view(np.int16)
        ).to(device),
        k,
        prob_bits=CTX_PROB_BITS if ctx else PROB_BITS,
        ctx_mode=ctx,
    )
    if not bool((ok == 1).all()):
        raise ValueError("rANS stream integrity check failed")
    out = _from_block_symbols(syms, b, s)
    return out << 4 if ctx else out

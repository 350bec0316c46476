"""Per-plane-batch rANS stream codec: host packaging + device coding.

One ``PlaneStream`` holds the entropy-coded bytes of one byte plane across a
whole batch of frames, sharing a single frequency table, in the
block-interleaved layout of ``fpv_tpu_torch.ops.rans_layout``.  The coding
itself runs through ``ops.rans_cuda`` (K1/K2 on CUDA tensors, their plain
versions on CPU tensors), for the 1024-lane device geometry and for narrow
streams alike.
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
    LANES_MIN,
    PROB_BITS,
    chunk_lens,
    num_blocks,
    num_segments,
)

# Narrow-stream encoder policy (rans_layout LANES_MIN): plane batches of at
# most this many symbols store fewer chunk states by using fewer lanes
# (each 1024-lane block costs ~3 KB of stored states).  Read at call time,
# so a test can lower it.
NARROW_MAX_SYMS = 4 << 20

# Longest chunk a narrow stream may use (bounds the serial steps of one
# block and the per-(block, segment) count array; the format itself allows
# up to 65536).
NARROW_MAX_K = 32768


def narrow_geometry(n: int) -> tuple[int, int]:
    """(lanes, stream chunk_len) for a small plane batch of n symbols.

    Narrow streams pick their own chunk length (one chunk spanning the
    whole lane where possible); the caller's chunk_len is not honored."""
    lanes = LANES_MIN
    while lanes < BLOCK_LANES and -(-n // lanes) > NARROW_MAX_K:
        lanes *= 2
    k = max(16, 1 << max(0, (-(-n // lanes)) - 1).bit_length())
    return lanes, min(k, NARROW_MAX_K)


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


def _to_block_symbols(
    plane: torch.Tensor, chunk_len: int, nblocks: int,
    lanes: int = BLOCK_LANES,
):
    """[B, S] u8 -> [nblocks, K, lanes] u8 — a pure reshape (zero-padded).

    With the interleaved lane layout (rans_layout.chunk_lens), the
    step-major array IS the flat symbol stream."""
    flat = plane.reshape(-1)
    pad = nblocks * chunk_len * lanes - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(nblocks, chunk_len, lanes)


def ctx_combine_device(prev: torch.Tensor, sym4: torch.Tensor) -> torch.Tensor:
    """(previous-step symbols, symbols) [nb, K', lanes] -> int64 fc indices
    ctx*16+sym (ctx feature defined in rans_layout)."""
    p = prev.to(torch.int64)
    al = torch.roll(p, 1, dims=2)
    ar = torch.roll(p, -1, dims=2)
    ctx = p * 2 + (al != ar).to(torch.int64)
    return ctx * CTX_ALPHA + sym4.to(torch.int64)


def ctx_indices_device(sym4: torch.Tensor) -> torch.Tensor:
    """[nb, K, lanes] nibble symbols (zero-padded) -> fc indices ctx*16+sym."""
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


def lens_tensor(
    nframes: int, plane_size: int, chunk_len: int, device,
    lanes: int = BLOCK_LANES,
):
    """Lane lengths [nblocks, lanes] int32 of a plane batch's stream
    (rans_layout.chunk_lens)."""
    lens = chunk_lens(nframes, plane_size, chunk_len, lanes)
    return torch.from_numpy(lens.reshape(-1, lanes)).to(device)


def code_blocks(
    plane: torch.Tensor,
    syms: torch.Tensor,
    lens: torch.Tensor,
    fc: torch.Tensor,
    freq: np.ndarray,
    coding: int,
    allow_raw: bool = True,
) -> PlaneStream:
    """K1 on block symbols [nblocks, K, lanes], then (``allow_raw``) the
    CODING_RAW policy: the [B, S] residual ``plane`` is stored verbatim
    whenever that is not larger than the coded stream (ties go to raw —
    same bytes, no decode kernel).  The sizes come from the counts alone,
    so a losing payload is never serialized."""
    b, s = plane.shape
    _nb, k, lanes = syms.shape
    ctx = coding == CODING_CTX16
    states, counts, payload = rans_cuda.rans_encode(
        syms, lens, fc, CTX_PROB_BITS if ctx else PROB_BITS, ctx
    )
    coded = coded_stream_bytes(lens.numel(), counts.numel(), payload.numel())
    if allow_raw and raw_stream_bytes(b * s) <= coded:
        return raw_plane_stream(b, s, k, plane.cpu().numpy())
    return PlaneStream(
        nframes=b, plane_size=s, chunk_len=k,
        freq=np.asarray(freq).astype(np.uint16),
        states=states.reshape(-1).cpu().numpy().view(np.uint32),
        block_counts=counts.cpu().numpy().astype(np.uint32),
        payload=payload.cpu().numpy().view(np.uint16),
        coding=coding,
        lanes=lanes,
    )


def encode_plane_batch(
    plane: torch.Tensor,
    hist: np.ndarray | None,
    chunk_len: int,
    coding: int = CODING_ORDER0,
    mask: np.ndarray | None = None,
    lanes: int | str | None = None,
    allow_raw: bool | None = None,
) -> PlaneStream:
    """Encode a [B, S] (or [B, H, W]) uint8 plane batch with host tables.

    ``hist`` is the 256-bin (order-0) histogram, ``mask`` an optional
    exact-support superset (tables.normalize_freqs floor_mask); with
    ``hist=None`` an exact histogram is taken here and its support is the
    mask.  With ``coding=CODING_CTX16`` (nibble alphabet + conditional
    tables) the joint (ctx, sym) histogram is computed here and ``hist`` is
    ignored: over the whole block array, padding included, for 1024-lane
    streams (the device route's exact-support superset), and over the
    coded positions only (exact) for narrow streams.

    ``lanes="auto"`` applies the encoder policy: constant plane batches
    short-circuit to a CODING_CONST stream, and batches of at most
    NARROW_MAX_SYMS symbols become narrow streams (:func:`narrow_geometry`,
    possibly with a longer chunk_len).  ``lanes="wide"`` applies only the
    const short-circuit and keeps 1024 lanes.  None and explicit lane
    counts pin the geometry and never change coding or chunk_len.

    ``allow_raw`` (default: on exactly for "auto"/"wide") replaces the
    coded stream with a CODING_RAW store whenever that is not larger.
    """
    b = plane.shape[0]
    plane = plane.reshape(b, -1)
    s = plane.shape[1]
    n = b * s
    auto = lanes in ("auto", "wide")
    if allow_raw is None:
        allow_raw = auto
    if auto:
        if lanes == "auto" and 0 < n <= NARROW_MAX_SYMS:
            lanes, chunk_len = narrow_geometry(n)
        else:
            lanes = BLOCK_LANES
    elif lanes is None:
        lanes = BLOCK_LANES
    if auto and n:
        vmin, vmax = (int(v) for v in torch.aminmax(plane))
        if vmin == vmax:
            return const_plane_stream(b, s, chunk_len, vmin)
    syms, lens, fc, freq = plane_blocks(plane, chunk_len, lanes, coding,
                                        hist, mask)
    return code_blocks(plane, syms, lens, fc, freq, coding, allow_raw)


def plane_blocks(
    plane: torch.Tensor,
    chunk_len: int,
    lanes: int,
    coding: int = CODING_ORDER0,
    hist: np.ndarray | None = None,
    mask: np.ndarray | None = None,
):
    """K1's inputs for a [B, S] u8 plane batch coded with host tables (see
    :func:`encode_plane_batch` for ``hist``/``mask`` and the ctx16
    histograms) -> (block symbols [nblocks, K, lanes], lens, encode table
    tensor, freq)."""
    b, s = plane.shape
    lens = lens_tensor(b, s, chunk_len, plane.device, lanes)
    nblocks = lens.shape[0]
    if coding == CODING_CTX16:
        syms = _to_block_symbols(plane >> 4, chunk_len, nblocks, lanes)
        idx = ctx_indices_device(syms)
        if lanes != BLOCK_LANES:
            steps = torch.arange(chunk_len, device=plane.device)
            idx = idx[steps[None, :, None] < lens[:, None, :]]
        jhist = _hist_flat(idx, CTX_NIDX).cpu().numpy()
        freq = normalize_freqs_ctx(jhist, floor_mask=jhist > 0)
        fc = rans_cuda.ctx_table_arrays(freq)
    else:
        if hist is None:
            hist = _hist_flat(plane, 256).cpu().numpy()
            mask = hist > 0
        freq = normalize_freqs(np.asarray(hist), ensure_all=True,
                               floor_mask=mask)
        syms = _to_block_symbols(plane, chunk_len, nblocks, lanes)
        fc = rans_cuda.table_arrays(freq)
    return syms, lens, rans_cuda.u32_tensor(fc, plane.device), freq


def decode_blocks(
    stream: PlaneStream, device, b0: int, b1: int
) -> torch.Tensor:
    """K2 on rANS blocks ``b0..b1`` (inclusive) of a coded stream -> their
    flat u8 symbols [(b1-b0+1) * K * lanes] on ``device`` (ctx16 nibbles
    moved back to the high nibble).  Only those blocks' states, counts and
    payload words are uploaded.  Raises ValueError when the rANS integrity
    check fails."""
    b, s, k, lanes = (stream.nframes, stream.plane_size, stream.chunk_len,
                      stream.lanes)
    nseg = num_segments(k)
    ctx = stream.coding == CODING_CTX16
    counts = stream.block_counts.astype(np.int64)
    cum = np.zeros(len(counts) + 1, np.int64)
    cum[1:] = np.cumsum(counts)
    g0, g1 = b0 * nseg, (b1 + 1) * nseg
    payload = np.ascontiguousarray(stream.payload[cum[g0] : cum[g1]],
                                   np.uint16)
    lens = chunk_lens(b, s, k, lanes).reshape(-1, lanes)[b0 : b1 + 1]
    table = (rans_cuda.ctx_fused_table_arrays(stream.freq) if ctx
             else rans_cuda.fused_table_arrays(stream.freq))
    syms, ok = rans_cuda.rans_decode(
        torch.from_numpy(counts[g0:g1].astype(np.int32)).to(device),
        torch.from_numpy(cum[g0:g1] - cum[g0]).to(device),
        rans_cuda.u32_tensor(
            stream.states[b0 * lanes : (b1 + 1) * lanes], device
        ).reshape(-1, lanes),
        torch.from_numpy(np.ascontiguousarray(lens)).to(device),
        rans_cuda.u32_tensor(table, device),
        torch.from_numpy(payload.view(np.int16)).to(device),
        k,
        prob_bits=CTX_PROB_BITS if ctx else PROB_BITS,
        ctx_mode=ctx,
    )
    if not bool((ok == 1).all()):
        raise ValueError("rANS stream integrity check failed")
    flat = syms.reshape(-1)
    return flat << 4 if ctx else flat


def decode_plane_range(
    stream: PlaneStream, device, lo: int, hi: int
) -> torch.Tensor:
    """Symbols ``lo:hi`` of a plane batch's flat stream -> u8 [hi - lo] on
    ``device``.  A coded stream decodes only the rANS blocks covering the
    range (blocks are contiguous in the flat stream), so one frame of a
    1024-lane batch costs at most ceil(S / (K * 1024)) + 1 blocks.  Raises
    ValueError when the rANS integrity check fails."""
    if stream.coding == CODING_CONST:
        return torch.full((hi - lo,), stream.value, dtype=torch.uint8,
                          device=device)
    if stream.coding == CODING_RAW:
        return torch.from_numpy(stream.raw_bytes[lo:hi].copy()).to(device)
    span = stream.chunk_len * stream.lanes
    b0 = lo // span
    flat = decode_blocks(stream, device, b0, (hi - 1) // span)
    return flat[lo - b0 * span : hi - b0 * span]


def decode_plane_batch(stream: PlaneStream, device) -> torch.Tensor:
    """Decode a PlaneStream -> [B, S] uint8 tensor on ``device``; raises
    ValueError when the rANS integrity check fails."""
    b, s = stream.nframes, stream.plane_size
    return decode_plane_range(stream, device, 0, b * s).reshape(b, s)

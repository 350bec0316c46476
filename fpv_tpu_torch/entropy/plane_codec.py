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
from typing import NamedTuple

import numpy as np
import torch

from fpv_tpu_torch.entropy.tables import normalize_freqs, normalize_freqs_ctx
from fpv_tpu_torch.ops import rans_cuda
from fpv_tpu_torch.ops.rans_cuda import PAYLOAD_ALIGN, PAYLOAD_PAD
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


class PlaneJob(NamedTuple):
    """One plane batch ready for K1: the [B, S] u8 residual ``plane``, its
    block symbols [nblocks, K, lanes] (ctx16: nibbles), lane lengths,
    encode table tensor, frequency table (numpy or tensor) and coding."""

    plane: torch.Tensor
    syms: torch.Tensor
    lens: torch.Tensor
    fc: torch.Tensor
    freq: np.ndarray | torch.Tensor
    coding: int


def code_planes(jobs: list[PlaneJob], allow_raw: bool = True
                ) -> list[PlaneStream]:
    """K1 on several plane batches at once (one launch of each pass), then
    per plane (``allow_raw``) the CODING_RAW policy: the [B, S] residual
    plane is stored verbatim whenever that is not larger than the coded
    stream (ties go to raw — same bytes, no decode kernel).  The sizes
    come from the counts alone, so a losing payload is never serialized.
    States, counts and frequency tables come to the host in one copy
    each, then each coded plane's payload."""
    coded = rans_cuda.rans_encode_grouped([
        rans_cuda.EncodePlane(
            j.syms, j.lens, j.fc,
            CTX_PROB_BITS if j.coding == CODING_CTX16 else PROB_BITS,
            j.coding == CODING_CTX16,
        ) for j in jobs
    ])
    states = torch.cat([st.reshape(-1) for st, _c, _p in coded]).cpu()
    counts = torch.cat([c for _s, c, _p in coded]).cpu()
    freqs = [j.freq for j in jobs]
    dev_freqs = [f.reshape(-1) for f in freqs if isinstance(f, torch.Tensor)]
    if dev_freqs:
        host = iter(torch.cat(dev_freqs).cpu().split(
            [f.numel() for f in dev_freqs]))
        freqs = [next(host).numpy() if isinstance(f, torch.Tensor) else f
                 for f in freqs]
    out = []
    s0 = c0 = 0
    for job, freq, (st, cnt, payload) in zip(jobs, freqs, coded):
        b, s = job.plane.shape
        _nb, k, lanes = job.syms.shape
        s1, c1 = s0 + st.numel(), c0 + cnt.numel()
        size = coded_stream_bytes(st.numel(), cnt.numel(), payload.numel())
        if allow_raw and raw_stream_bytes(b * s) <= size:
            out.append(raw_plane_stream(b, s, k, job.plane.cpu().numpy()))
        else:
            out.append(PlaneStream(
                nframes=b, plane_size=s, chunk_len=k,
                freq=np.asarray(freq).astype(np.uint16),
                states=states[s0:s1].numpy().view(np.uint32),
                block_counts=counts[c0:c1].numpy().astype(np.uint32),
                payload=payload.cpu().numpy().view(np.uint16),
                coding=job.coding,
                lanes=lanes,
            ))
        s0, c0 = s1, c1
    return out


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
    return code_planes([PlaneJob(plane, syms, lens, fc, freq, coding)],
                       allow_raw)[0]


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


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  To a CUDA device it goes
    through pinned memory without waiting for the device: the copy is
    queued on the current stream, as a kernel launch is.  On the CPU the
    tensor shares the array's memory."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def decode_launch_args(stream: PlaneStream, device
                       ) -> list[rans_cuda.DecodePlane]:
    """The :class:`rans_cuda.DecodePlane` list that the production reader
    would launch K2 on for a coded ``stream`` (all its blocks), built by
    :func:`stage_blocks` itself: the counterpart of JAX's
    ``pallas_decode_args``.  ``ops/rans_bound.py`` times K2's variants on
    these, so the replicas share the production launch configuration by
    construction."""
    if stream.coding not in (CODING_ORDER0, CODING_CTX16):
        raise ValueError("only a coded (order-0 or ctx16) stream has K2 "
                         "launch arguments")
    return stage_blocks([("", stream, 0, stream.num_blocks - 1)],
                        device).planes


class StagedBlocks(NamedTuple):
    """K2's inputs for several coded block ranges, on the device: one
    :class:`rans_cuda.DecodePlane` and one name per job."""

    names: list[str]
    planes: list[rans_cuda.DecodePlane]


def stage_blocks(
    jobs: list[tuple[str, PlaneStream, int, int]], device
) -> StagedBlocks:
    """Upload rANS blocks ``b0..b1`` (inclusive) of several coded streams,
    ``jobs`` of (name, stream, b0, b1), for one K2 launch: only those
    blocks' states, counts and payload words, each kind of table in one
    copy, the payload slices 16-byte aligned in one padded buffer, as K2
    stages them.  Nothing waits for the device."""
    dev = torch.device(device)
    parts = {k: [] for k in ("counts", "starts", "states", "lens", "table")}
    pay_off, pays, pos = [], [], 0
    for _name, st, b0, b1 in jobs:
        lanes, nseg = st.lanes, num_segments(st.chunk_len)
        counts = st.block_counts.astype(np.int64)
        cum = np.zeros(len(counts) + 1, np.int64)
        cum[1:] = np.cumsum(counts)
        g0, g1 = b0 * nseg, (b1 + 1) * nseg
        ctx = st.coding == CODING_CTX16
        parts["counts"].append(counts[g0:g1].astype(np.int32))
        parts["starts"].append(cum[g0:g1] - cum[g0])
        parts["states"].append(st.states[b0 * lanes : (b1 + 1) * lanes]
                               .view(np.int32))
        parts["lens"].append(chunk_lens(st.nframes, st.plane_size,
                                        st.chunk_len, lanes)
                             [b0 * lanes : (b1 + 1) * lanes])
        parts["table"].append(
            (rans_cuda.ctx_fused_table_arrays(st.freq) if ctx
             else rans_cuda.fused_table_arrays(st.freq)).view(np.int32))
        pays.append(st.payload[cum[g0] : cum[g1]])
        pay_off.append(pos)
        pos += -(-len(pays[-1]) // PAYLOAD_ALIGN) * PAYLOAD_ALIGN
    # each slice goes straight to its place in one host buffer, uploaded in
    # one copy (the pad past the last slice is never read as a word, only
    # staged)
    host_pay = torch.empty(pos + PAYLOAD_PAD, dtype=torch.int16,
                           pin_memory=dev.type == "cuda")
    view = host_pay.numpy()
    for off, p in zip(pay_off, pays):
        view[off : off + len(p)] = p.view(np.int16)
    dev_pay = host_pay.to(dev, non_blocking=True)
    on_dev = {k: upload(np.concatenate(v), dev).split([len(a) for a in v])
              for k, v in parts.items()}
    planes = []
    for i, (_name, st, _b0, _b1) in enumerate(jobs):
        ctx = st.coding == CODING_CTX16
        planes.append(rans_cuda.DecodePlane(
            on_dev["counts"][i], on_dev["starts"][i],
            on_dev["states"][i].view(-1, st.lanes),
            on_dev["lens"][i].view(-1, st.lanes), on_dev["table"][i],
            dev_pay[pay_off[i] : pay_off[i] + len(pays[i])], st.chunk_len,
            CTX_PROB_BITS if ctx else PROB_BITS, ctx,
        ))
    return StagedBlocks([name for name, *_ in jobs], planes)


def launch_blocks(
    staged: StagedBlocks, only=None
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """K2 on staged blocks in one launch (``only``: the job indices to
    decode, default all) -> each job's flat u8 symbols
    [(b1-b0+1) * K * lanes] (ctx16 nibbles moved back to the high nibble)
    and a bool tensor [jobs] of their integrity checks, still on the
    device: nothing waits for it."""
    idx = range(len(staged.planes)) if only is None else only
    planes = [staged.planes[i] for i in idx]
    decoded = rans_cuda.rans_decode_grouped(planes)
    ok = torch.stack([(o == 1).all() for _s, o in decoded])
    syms = [s.reshape(-1) << 4 if p.ctx_mode else s.reshape(-1)
            for p, (s, _o) in zip(planes, decoded)]
    return syms, ok


def raise_if_bad(names: list[str], ok: list[bool]) -> None:
    """ValueError naming the first plane whose integrity check failed."""
    for name, good in zip(names, ok):
        if not good:
            what = f" ({name} plane)" if name else ""
            raise ValueError(f"rANS stream integrity check failed{what}")


def decode_blocks_grouped(
    jobs: list[tuple[str, PlaneStream, int, int]], device
) -> list[torch.Tensor]:
    """K2 on rANS blocks ``b0..b1`` (inclusive) of several coded streams,
    ``jobs`` of (name, stream, b0, b1), in one launch -> each job's flat u8
    symbols on ``device`` (:func:`stage_blocks`, :func:`launch_blocks`).
    The ok flags are read once; a failed check raises ValueError naming
    the plane."""
    staged = stage_blocks(jobs, device)
    syms, ok = launch_blocks(staged)
    raise_if_bad(staged.names, ok.cpu().tolist())
    return syms


def decode_plane_ranges(
    requests: list[tuple[str, PlaneStream, int, int]], device
) -> list[torch.Tensor]:
    """Symbols ``lo:hi`` of plane batches' flat streams, ``requests`` of
    (name, stream, lo, hi) -> u8 [hi - lo] each on ``device``.  The coded
    streams decode in one K2 launch, each from only the rANS blocks
    covering its range (blocks are contiguous in the flat stream), so one
    frame of a 1024-lane batch costs at most ceil(S / (K * 1024)) + 1
    blocks per plane.  Raises ValueError when a rANS integrity check
    fails."""
    out, jobs, where = _split_ranges(requests, device)
    if jobs:
        for (i, a, n), flat in zip(where,
                                   decode_blocks_grouped(jobs, device)):
            out[i] = flat[a : a + n]
    return out


def _split_ranges(requests, device):
    """CONST and RAW requests' symbols on ``device`` (the rest None), the
    coded requests as block jobs, and where each job's symbols go: (request
    index, offset into the job's symbols, count)."""
    out: list[torch.Tensor | None] = [None] * len(requests)
    jobs, where = [], []
    for i, (name, st, lo, hi) in enumerate(requests):
        if st.coding == CODING_CONST:
            out[i] = torch.full((hi - lo,), st.value, dtype=torch.uint8,
                                device=device)
        elif st.coding == CODING_RAW:
            out[i] = upload(st.raw_bytes[lo:hi], device)
        else:
            span = st.chunk_len * st.lanes
            jobs.append((name, st, lo // span, (hi - 1) // span))
            where.append((i, lo - lo // span * span, hi - lo))
    return out, jobs, where


class StagedRanges(NamedTuple):
    """:func:`stage_plane_ranges`'s result: per request its name, and its
    symbols where no kernel is needed (CONST, RAW) or None; the coded
    requests' staged blocks and where their symbols go."""

    names: list[str]
    direct: list[torch.Tensor | None]
    blocks: StagedBlocks | None
    where: list[tuple[int, int, int]]


def stage_plane_ranges(
    requests: list[tuple[str, PlaneStream, int, int]], device
) -> StagedRanges:
    """The staging half of :func:`decode_plane_ranges`: every upload, no
    kernel, nothing waits for the device."""
    out, jobs, where = _split_ranges(requests, device)
    return StagedRanges([r[0] for r in requests], out,
                        stage_blocks(jobs, device) if jobs else None, where)


def launch_plane_ranges(
    staged: StagedRanges, names
) -> tuple[dict[str, torch.Tensor], list[str], torch.Tensor | None]:
    """The launch half of :func:`decode_plane_ranges`, for the requests
    named in ``names``: their u8 symbols by name, the names of the coded
    ones and a bool tensor of those's integrity checks (None when none is
    coded), from one K2 launch.  Nothing waits for the device: the caller
    reads the checks (:func:`raise_if_bad`)."""
    want = set(names)
    out = {n: t for n, t in zip(staged.names, staged.direct)
           if n in want and t is not None}
    jobs = [j for j, (i, _a, _n) in enumerate(staged.where)
            if staged.names[i] in want]
    if not jobs:
        return out, [], None
    syms, ok = launch_blocks(staged.blocks, jobs)
    for j, flat in zip(jobs, syms):
        i, a, n = staged.where[j]
        out[staged.names[i]] = flat[a : a + n]
    return out, [staged.blocks.names[j] for j in jobs], ok


def decode_plane_batch(
    stream: PlaneStream, device, name: str = ""
) -> torch.Tensor:
    """Decode one PlaneStream -> [B, S] uint8 tensor on ``device``; raises
    ValueError when the rANS integrity check fails."""
    b, s = stream.nframes, stream.plane_size
    return decode_plane_ranges([(name, stream, 0, b * s)],
                               device)[0].reshape(b, s)

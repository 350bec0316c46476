"""FPVT batched codec on PyTorch: encode -> FPVT bytes -> decode.

Encode path per batch of frames (one model step + three rANS encodes):

    [B,H,W] u16 --split--> high/low planes --box--> previews
        --temporal?--> --spatial?--> residual planes + per-frame flags
        --histogram--> tables --rANS (K1)--> plane streams

Decode inverts: rANS (K2) -> inverse spatial (prefix sum for 'up', the
CG2D wavefront K3) -> temporal add -> plane combine.

Every public entry point takes ``device=`` (default ``"cuda"``): the data
lives there, and each kernel wrapper launches its CUDA kernel on a CUDA
device or runs its plain PyTorch version on the CPU.  The files written are
byte-identical to the JAX package's writer: small files (at most
NARROW_MAX_SYMS body symbols) code their plane batches as narrow streams
through the per-plane route, larger ones take the fused 1024-lane route of
the JAX device writer.  Narrow streams run on the same kernels as wide
ones (the JAX package codes them on the host).

The reader decodes whole batches, single frames from only the rANS blocks
that cover them (random access), previews, and (FpvtStreamingReader)
files that arrive in pieces.

Host stages are named ranges (``utils.profiling.annotate``: profiler
ranges while a profiler records, beside the kernels they launch):
``fpvt.write.upload`` / ``code`` / ``serialize`` per batch and
``fpvt.write.join`` per file; ``fpvt.read.open`` per reader,
``fpvt.read.parse`` per batch section parsed, ``stage``, ``dispatch`` and
``finalize`` per batch decoded, ``assemble`` per ``decode_file_fpvt``, and
in ``decode_frame`` ``fpvt.read.chain`` around the one staging and K2
launch of the prev chain walked and ``fpvt.read.download`` for the
answer.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct

import numpy as np
import torch

from fpv_tpu_torch.entropy import plane_codec
from fpv_tpu_torch.entropy.plane_codec import (
    PlaneJob,
    PlaneStream,
    _hist_flat,
    _to_block_symbols,
    code_planes,
    const_plane_stream,
    ctx_combine_device,
    ctx_presence_device,
    encode_plane_batch,
    lens_tensor,
    upload,
)
from fpv_tpu_torch.entropy.tables_device import (
    encode_tables_ctx_device,
    encode_tables_device,
    normalize_freqs_ctx_device,
    normalize_freqs_device,
)
from fpv_tpu_torch.format import fpvt
from fpv_tpu_torch.format.fpvt import (
    F_NO_LOW,
    F_PV_SPATIAL_SHIFT,
    F_PV_USE_DELTA,
    F_SPATIAL_SHIFT,
    F_USE_DELTA,
    F_USE_PREV,
    SPATIAL_CG2D,
    SPATIAL_UP,
    Header,
)
from fpv_tpu_torch.ops import rans_cuda
from fpv_tpu_torch.ops.planes import (
    combine_planes,
    resolve_u8_shift,
    split_planes,
    to_int16,
    validate_u8_config,
)
from fpv_tpu_torch.ops.predict import (
    cg2d_decode,
    cg2d_encode,
    clamped_gradient,
    up_decode,
    up_encode,
)
from fpv_tpu_torch.ops.preview import generate_preview
from fpv_tpu_torch.ops.rans_layout import (
    BLOCK_COLS,
    BLOCK_LANES,
    CODING_CONST,
    CODING_CTX16,
    CODING_ORDER0,
    CODING_RAW,
    CTX_NIDX,
    CTX_PROB_BITS,
    PROB_BITS,
    SEG_LEN,
    chunk_lens,
    num_blocks,
    num_segments,
)
from fpv_tpu_torch.utils import kernels
from fpv_tpu_torch.utils.profiling import annotate

# Per-batch size ceiling: one plane batch must stay below 2^31 symbols, the
# range of the kernels' int32 word offsets and counts.  Batches beyond it
# raise before anything is allocated.
MAX_DEVICE_SYMS = (1 << 31) - 1

_DECISION_STRIDE = 16  # sampling stride for predictor decisions
_HIST_STRIDE = 16  # sampling stride for rANS table histograms

# Preview streams code with their own shorter chunk length (a preview has
# 1/16 of a main plane's symbols); the wire format carries chunk_len per
# stream, so this is encoder policy.
PV_CHUNK_MAX = 512

# Prev-frame prediction anchor interval (encoder policy): every
# PREV_ANCHOR-th frame of a batch may not use F_USE_PREV, bounding random
# access chains.
PREV_ANCHOR = 8


def pv_chunk_len(chunk_len: int) -> int:
    """The chunk length preview streams are coded with."""
    return min(chunk_len, PV_CHUNK_MAX)


# ---------------------------------------------------------------------------
# modeling: decisions, residuals, histograms


def _sample_rows(plane: torch.Tensor, stride: int) -> torch.Tensor:
    """Row-strided sample of a [B, H, W] plane."""
    return plane[:, ::stride]


def _frame_rows(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """plane[b, idx[b, r], :] -> [B, R, W]."""
    b = plane.shape[0]
    rows = torch.arange(b, device=plane.device)[:, None]
    return plane[rows, idx]


def _sample_rows_rotating(plane: torch.Tensor, stride: int) -> torch.Tensor:
    """Row sample with a per-frame phase: frame i samples rows
    ``(i % stride) + stride*j`` (a fixed phase would let content hide on
    the never-sampled rows)."""
    b, h, _w = plane.shape
    nr = max(h // stride, 1)
    dev = plane.device
    offs = torch.arange(b, device=dev) % stride
    offs = torch.clamp(offs, max=max(h - 1 - (nr - 1) * stride, 0))
    idx = offs[:, None] + stride * torch.arange(nr, device=dev)[None, :]
    return _frame_rows(plane, idx)


# The JAX package sums decision costs in float32, and on the CPU XLA's
# TreeReductionRewriter fixes the order: a reduction of n >= 32 elements
# becomes a reduce-window of 32 with "same" padding (p = 32*ceil(n/32) - n
# zeros, p//2 of them before the first element), each window summed in
# order from 0.0, until fewer than 32 partials remain, which are then summed
# in order.  Near ties past 2^24 round differently in any other order, so
# the port rebuilds this one with explicit elementwise float32 adds (never
# torch.sum on floats, whose order differs between the CPU and the card).
# Magnitudes are at most 128, so the first three levels (runs of 32^3
# elements, sums below 2^22) are exact and come from int64 sums.
_TREE = 32
_EXACT_LEVELS = 3


def _mags(x: torch.Tensor) -> torch.Tensor:
    """[B, ...] u8 residuals -> [B, N] int32 wraparound magnitudes."""
    xi = x.to(torch.int32).reshape(x.shape[0], -1)
    return torch.minimum(xi, 256 - xi)


def _same_pad(n: int) -> tuple[int, int]:
    """(front, back) zeros of one tree level over ``n`` >= 32 values."""
    p = -(-n // _TREE) * _TREE - n
    return p // 2, p - p // 2


def _runs(n: int) -> tuple[int, int, int]:
    """(front, run, count): where the exact levels' partials of ``n``
    elements lie — run k covers elements [k*run - front, (k+1)*run - front)
    of the flat input.  Below 32^3 elements the whole sum is one exact run."""
    run = _TREE ** _EXACT_LEVELS
    if n < run:
        return 0, max(n, 1), 1
    front, scale = 0, 1
    for _ in range(_EXACT_LEVELS):
        front += _same_pad(n)[0] * scale
        n, scale = -(-n // _TREE), scale * _TREE
    return front, run, n


def _run_sums(mag: torch.Tensor) -> torch.Tensor:
    """[B, N] magnitudes -> [B, count] int64 exact run sums (:func:`_runs`)."""
    b, n = mag.shape
    front, run, count = _runs(n)
    pad = torch.nn.functional.pad(mag, (front, count * run - front - n))
    return pad.reshape(b, count, run).sum(dim=2, dtype=torch.int64)


def _tree_f32(runs: torch.Tensor) -> torch.Tensor:
    """[B, M] int64 run sums -> [B] float32 sums, added in XLA:CPU's tree
    order from the exact levels on."""
    v = runs.to(torch.float32)
    while v.shape[1] >= _TREE:
        v = torch.nn.functional.pad(v, _same_pad(v.shape[1]))
        v = v.reshape(v.shape[0], -1, _TREE)
        acc = torch.zeros(v.shape[:2], dtype=torch.float32, device=v.device)
        for i in range(_TREE):
            acc = acc + v[:, :, i]
        v = acc
    acc = torch.zeros(v.shape[0], dtype=torch.float32, device=v.device)
    for i in range(v.shape[1]):
        acc = acc + v[:, i]
    return acc


def _cost(x: torch.Tensor) -> torch.Tensor:
    """Per-frame float32 sum of wraparound magnitudes of mod-256
    residuals, in the JAX package's order (see ``_TREE``)."""
    return _tree_f32(_run_sums(_mags(x)))


def _residual_cost(plane: torch.Tensor) -> torch.Tensor:
    """Per-frame predictor-choice proxy: :func:`_cost` on rotating samples."""
    return _cost(_sample_rows_rotating(plane, _DECISION_STRIDE))


def _exact_hist_256(plane: torch.Tensor) -> torch.Tensor:
    """[256] int64 exact byte histogram of a plane batch."""
    return _hist_flat(plane.reshape(-1), 256)


def _support_mask(plane: torch.Tensor) -> torch.Tensor:
    """[256] 0/1 int32 exact-support superset of a u8 plane batch: the
    intersection of the value interval and the interval of the recentered
    ``(v+128) & 255`` domain (where mod-256 residuals clustered around 0 and
    255 form one run)."""
    if plane.numel() == 0:
        return torch.ones(256, dtype=torch.int32, device=plane.device)
    return _mask_of_ranges(_value_ranges(plane))


def _value_ranges(plane: torch.Tensor) -> torch.Tensor:
    """[4] int32 (min, max, recentered min, recentered max) of a non-empty
    u8 plane batch: what :func:`_support_mask` depends on."""
    v = plane.reshape(-1).to(torch.int32)
    r = (v + 128) & 255
    return torch.stack([v.min(), v.max(), r.min(), r.max()])


def _mask_of_ranges(ranges: torch.Tensor) -> torch.Tensor:
    """:func:`_support_mask` from :func:`_value_ranges`."""
    sym = torch.arange(256, dtype=torch.int32, device=ranges.device)
    m_plain = (sym >= ranges[0]) & (sym <= ranges[1])
    rsym = (sym + 128) & 255
    m_rec = (rsym >= ranges[2]) & (rsym <= ranges[3])
    return (m_plain & m_rec).to(torch.int32)


def _batch_hist(plane: torch.Tensor) -> torch.Tensor:
    """[256] int64 row-sampled histogram over the whole batch."""
    return _hist_flat(_sample_rows(plane, _HIST_STRIDE).reshape(-1), 256)


def _where3(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Per-frame select: c [B] bool, a/b [B, ...]."""
    return torch.where(c.reshape(-1, *([1] * (a.dim() - 1))), a, b)


def encode_model_step(
    imgs: torch.Tensor,
    delta_high: torch.Tensor,
    delta_low: torch.Tensor,
    shift: int = 0,
    big_endian: bool = False,
    use_delta_frame: bool = True,
    low_ctx: bool = False,
    allow_prev: bool = False,
) -> dict:
    """The per-batch modeling step (everything but entropy coding).

    ``imgs`` int32 [B, H, W] u16 samples; the delta planes u8 [H, W].
    Returns residual planes, previews, per-frame decisions and batch
    histograms, all on the images' device — the same dict as the JAX
    package's ``encode_model_step``.  ``allow_prev`` adds the prev-frame
    temporal candidate (F_USE_PREV) on every non-anchor frame.
    """
    high, low, nonzero_low = split_planes(imgs, shift, big_endian)
    pv = generate_preview(high)
    b = imgs.shape[0]
    dev = imgs.device
    no = torch.zeros(b, dtype=torch.bool, device=dev)

    if use_delta_frame:
        dh = high - delta_high[None]
        dl = low - delta_low[None]
        cost_none = _residual_cost(high)
        cost_stat = _residual_cost(dh)
        if allow_prev:
            dph = high - torch.cat([delta_high[None], high[:-1]])
            dpl = low - torch.cat([delta_low[None], low[:-1]])
            anchored = (torch.arange(b, device=dev) % PREV_ANCHOR) == 0
            cost_prev = torch.where(
                anchored, torch.tensor(float("inf"), device=dev),
                _residual_cost(dph),
            )
            mode = torch.argmin(
                torch.stack([cost_none, cost_stat, cost_prev]), dim=0
            )
            use_delta = mode == 1
            use_prev = mode == 2
            high2 = _where3(use_prev, dph, _where3(use_delta, dh, high))
            low2 = _where3(use_prev, dpl, _where3(use_delta, dl, low))
        else:
            use_delta = cost_stat < cost_none
            use_prev = no
            high2 = _where3(use_delta, dh, high)
            low2 = _where3(use_delta, dl, low)
    else:
        use_delta = use_prev = no
        high2, low2 = high, low

    # spatial decision from sampled row PAIRS with a per-frame rotating phase
    hh = high2.shape[1]
    nrp = max((hh - 1) // _DECISION_STRIDE, 1)
    offs = torch.arange(b, device=dev) % _DECISION_STRIDE
    offs = torch.clamp(
        offs, max=max(hh - 2 - (nrp - 1) * _DECISION_STRIDE, 0)
    )
    pidx = offs[:, None] + _DECISION_STRIDE * torch.arange(
        nrp, device=dev
    )[None, :]
    nr = _frame_rows(high2, pidx)
    cur_rows = _frame_rows(high2, torch.clamp(pidx + 1, max=hh - 1))
    up_s = cur_rows - nr
    cg_s = cur_rows - clamped_gradient(
        nr, torch.roll(cur_rows, 1, dims=2), torch.roll(nr, 1, dims=2)
    )
    ent = torch.stack([_cost(cur_rows), _cost(up_s), _cost(cg_s)])
    spatial = torch.argmin(ent, dim=0).to(torch.int32)  # [B] in {0,1,2}
    high3 = _where3(
        spatial == SPATIAL_UP,
        up_encode(high2),
        _where3(spatial == SPATIAL_CG2D, cg2d_encode(high2), high2),
    )

    # preview delta prediction (F_PV_USE_DELTA) against the delta frame's
    # preview, which both sides can compute.  Frames under 4x4 have empty
    # previews, whose candidates all cost the same: no delta, no predictor.
    if pv.numel() == 0:
        pv_use_delta = no
        pv_spatial = torch.zeros(b, dtype=torch.int32, device=dev)
        pv3 = pv
    else:
        if use_delta_frame:
            pvd = pv - generate_preview(delta_high[None])[0][None]
            pv_use_delta = _residual_cost(pvd) < _residual_cost(pv)
            pv2 = _where3(pv_use_delta, pvd, pv)
        else:
            pv_use_delta = no
            pv2 = pv
        p_up = up_encode(pv2)
        p_cg = cg2d_encode(pv2)
        pent = torch.stack(
            [_residual_cost(pv2), _residual_cost(p_up), _residual_cost(p_cg)]
        )
        pv_spatial = torch.argmin(pent, dim=0).to(torch.int32)
        pv3 = _where3(
            pv_spatial == SPATIAL_UP,
            p_up,
            _where3(pv_spatial == SPATIAL_CG2D, p_cg, pv2),
        )
    pv_hist = _exact_hist_256(pv3)
    return dict(
        high=high3,
        low=low2,
        preview=pv3,
        use_delta=use_delta,
        use_prev=use_prev,
        spatial=spatial,
        pv_spatial=pv_spatial,
        pv_use_delta=pv_use_delta,
        nonzero_low=nonzero_low,
        hist_high=_batch_hist(high3),
        # the ctx16 low mode builds its joint histogram from the block
        # layout in fused_encode_batch instead
        hist_low=None if low_ctx else _batch_hist(low2),
        hist_preview=pv_hist,
        mask_high=_support_mask(high3),
        mask_low=None if low_ctx else _support_mask(low2),
        mask_preview=(pv_hist > 0).to(torch.int32),
    )


def _pack_flags(m: dict) -> np.ndarray:
    """Per-frame decisions -> u8 frame flags (format/fpvt.py bits)."""
    def host(name):
        return m[name].cpu().numpy().astype(np.uint8)

    return (
        host("use_delta") * F_USE_DELTA
        | (host("spatial") << F_SPATIAL_SHIFT)
        | (1 - host("nonzero_low")) * F_NO_LOW
        | (host("pv_spatial") << F_PV_SPATIAL_SHIFT)
        | host("pv_use_delta") * F_PV_USE_DELTA
        | host("use_prev") * F_USE_PREV
    ).astype(np.uint8)


def _fused_plane_job(
    plane: torch.Tensor, k: int, hist, mask, ctx: bool
) -> PlaneJob:
    """K1's inputs for one residual plane batch [B, S] with device tables
    (the ctx16 table histogram samples the step axis; ctx*16+sym itself is
    computed inside K1 from the previous step's symbols)."""
    b, s = plane.shape
    lens = lens_tensor(b, s, k, plane.device)
    nblocks = lens.shape[0]
    if ctx:
        syms = _to_block_symbols(plane >> 4, k, nblocks)
        sampled = syms[:, ::_HIST_STRIDE]
        prev_s = torch.cat(
            [
                torch.zeros_like(syms[:, :1]),
                syms[:, _HIST_STRIDE - 1 : -1 : _HIST_STRIDE],
            ],
            dim=1,
        )[:, : sampled.shape[1]]
        hist = _hist_flat(ctx_combine_device(prev_s, sampled), CTX_NIDX)
        freq = normalize_freqs_ctx_device(hist, ctx_presence_device(syms))
        fc = encode_tables_ctx_device(freq)
    else:
        syms = _to_block_symbols(plane, k, nblocks)
        freq = normalize_freqs_device(hist, mask)
        fc = encode_tables_device(freq)
    return PlaneJob(plane, syms, lens, fc, freq,
                    CODING_CTX16 if ctx else CODING_ORDER0)


def fused_encode_batch(
    imgs: torch.Tensor,
    delta_high: torch.Tensor,
    delta_low: torch.Tensor,
    shift: int,
    big_endian: bool,
    chunk_len: int,
    low_coding: int = CODING_ORDER0,
    allow_prev: bool = True,
):
    """Whole-batch FPVT encode in the 1024-lane device geometry -> (frame
    flags u8 [B], (high, low, preview) PlaneStreams; the preview is None
    for frames under 4x4), with the static-delta and (``allow_prev``)
    prev-frame temporal candidates.  Tables are normalized on the device;
    one sync reads every plane's value range (CODING_CONST), then the
    coded planes go through one K1a and one K1b launch together, and only
    tables, states, counts and the tight payloads come to the host."""
    low_ctx = low_coding == CODING_CTX16
    m = encode_model_step(
        imgs, delta_high, delta_low, shift, big_endian, True, low_ctx,
        allow_prev,
    )
    b = imgs.shape[0]
    names = [n for n in ("high", "low", "preview") if m[n].numel()]
    planes = {n: m[n].reshape(b, -1) for n in names}
    ranges = torch.stack(
        [torch.stack(torch.aminmax(planes[n])) for n in names]
    ).cpu().tolist() if names else []
    streams: dict[str, PlaneStream | None] = dict.fromkeys(
        ("high", "low", "preview"))
    jobs = {}
    for n, (vmin, vmax) in zip(names, ranges):
        k = pv_chunk_len(chunk_len) if n == "preview" else chunk_len
        if vmin == vmax:
            streams[n] = const_plane_stream(b, planes[n].shape[1], k, vmin)
        else:
            jobs[n] = _fused_plane_job(planes[n], k, m[f"hist_{n}"],
                                       m[f"mask_{n}"], n == "low" and low_ctx)
    if jobs:
        streams.update(zip(jobs, code_planes(list(jobs.values()))))
    return _pack_flags(m), (streams["high"], streams["low"],
                            streams["preview"])


def put_frames(frames: np.ndarray, device) -> torch.Tensor:
    """u16 (or u8) frames -> int32 tensor of u16 samples on ``device``
    (uploaded as 16- or 8-bit words, widened there)."""
    arr = np.ascontiguousarray(frames)
    if arr.dtype == np.uint8:
        return torch.from_numpy(arr).to(device).to(torch.int32)
    arr = arr.astype(np.uint16, copy=False).view(np.int16)
    return torch.from_numpy(arr).to(device).to(torch.int32) & 0xFFFF


class FpvtWriter:
    """Streaming FPVT file writer: init -> encode_batch* -> finish."""

    def __init__(
        self,
        xsize: int,
        ysize: int,
        shift: int = 0,
        big_endian: bool = False,
        frames_per_batch: int = 16,
        chunk_log2: int = 12,
        device="cuda",
        delta_is_frame0: bool = False,
        narrow: bool = True,
        temporal_prev: bool = True,
    ) -> None:
        """``delta_is_frame0``: the delta frame given to :meth:`init` is
        frame 0 of the file (HDR_F_DELTA_IS_FRAME0), so batches start at
        frame 1.

        ``narrow``: apply the small-batch encoder policy.  Batches of at
        most NARROW_MAX_SYMS symbols take the per-plane route, whose plane
        streams may be CODING_CONST or narrow (fewer stored chunk states);
        the rest take the fused 1024-lane route.  The saving only matters
        when the whole file is small, so :func:`encode_file_fpvt` decides
        from the file's size.

        ``temporal_prev``: allow per-frame prev-frame prediction
        (F_USE_PREV, anchored every PREV_ANCHOR frames)."""
        if not 4 <= chunk_log2 <= 16:
            raise ValueError("chunk_log2 must be in [4, 16]")
        self._device = resolve_device(device)
        self._narrow = narrow
        self._allow_prev = temporal_prev
        self.header = Header(
            xsize=xsize,
            ysize=ysize,
            shift=shift,
            big_endian=big_endian,
            chunk_log2=chunk_log2,
            frames_per_batch=frames_per_batch,
            delta_is_frame0=delta_is_frame0,
        )
        self._chunk_len = 1 << chunk_log2
        # shift >= 4 guarantees the low plane's bottom nibble is zero,
        # enabling the context-coded 16-symbol mode
        self._low_coding = CODING_CTX16 if shift >= 4 else CODING_ORDER0
        self._delta_high: torch.Tensor | None = None
        self._delta_low: torch.Tensor | None = None
        self._batch_offsets: list[tuple[int, int]] = []
        self._bytes_written = 0
        self._total_frames = 0

    def _put(self, frames: np.ndarray) -> torch.Tensor:
        """:func:`put_frames` onto the writer's device."""
        return put_frames(frames, self._device)

    def _put_planes(self, high: np.ndarray, low: np.ndarray | None):
        """[..., H, W] u8 byte planes -> int32 left-aligned samples
        ``high << 8 | low`` on the writer's device."""
        high = np.ascontiguousarray(high, dtype=np.uint8)
        imgs = self._put(high) << 8
        if low is not None:
            low = np.ascontiguousarray(low, dtype=np.uint8)
            if low.shape != high.shape:
                raise ValueError("low plane shape must match high plane")
            imgs = imgs | self._put(low)
        return imgs

    def init(self, delta_frame: np.ndarray) -> bytes:
        """Header + delta section bytes; keeps the delta planes on device.

        uint8 delta frames are accepted under a shift-8 little-endian
        header (8-bit direct input)."""
        delta_frame = np.asarray(delta_frame)
        if delta_frame.dtype == np.uint8:
            validate_u8_config(self.header.shift, self.header.big_endian)
        img = self._put(
            delta_frame.reshape(1, self.header.ysize, self.header.xsize)
        )
        return self._init_core(img, self.header.shift, self.header.big_endian)

    def init_planes(
        self, high: np.ndarray, low: np.ndarray | None = None
    ) -> bytes:
        """Plane-adopting twin of :meth:`init`: the delta frame enters as
        pre-split [H, W] uint8 byte planes; the bytes equal :meth:`init`'s
        on the combined image."""
        h, w = self.header.ysize, self.header.xsize
        if np.shape(high) != (h, w):
            raise ValueError("high plane must be [ysize, xsize] uint8")
        imgs = self._put_planes(high, low).reshape(1, h, w)
        # the combined image is left-aligned: a shift-0 little-endian split
        # recovers exactly the planes given
        return self._init_core(imgs, 0, False)

    def _init_core(
        self, img: torch.Tensor, split_shift: int, split_big_endian: bool
    ) -> bytes:
        """The delta section of a [1, H, W] int32 image.

        Its high plane takes the spatial predictor with the least exact
        Shannon entropy (one frame, host-side decision).  Small delta planes
        (narrow writers, at most 512 Ki pixels) take the narrow policy with
        exact histograms; larger ones keep 1024 lanes and row-sampled
        histograms.  Both planes are coded with host-normalized tables."""
        high, low, nonzero_low = split_planes(
            img, split_shift, split_big_endian
        )
        self._delta_high = high[0]
        self._delta_low = low[0]
        has_low = bool(nonzero_low[0])
        cands = [high, up_encode(high), cg2d_encode(high)]

        def _entropy_bits(c: torch.Tensor) -> float:
            cnt = _exact_hist_256(c).cpu().numpy()
            p = cnt[cnt > 0] / max(cnt.sum(), 1)
            return float(-(p * np.log2(p)).sum()) * c.numel()

        spatial = int(np.argmin([_entropy_bits(c) for c in cands]))
        hres = cands[spatial]
        small = self._narrow and (
            self.header.ysize * self.header.xsize
            <= min(512 * 1024, plane_codec.NARROW_MAX_SYMS)
        )

        def code(plane: torch.Tensor, coding: int) -> PlaneStream:
            order0 = coding == CODING_ORDER0 and not small
            return encode_plane_batch(
                plane.reshape(1, -1),
                _batch_hist(plane).cpu().numpy() if order0 else None,
                self._chunk_len,
                coding=coding,
                mask=_support_mask(plane).cpu().numpy() if order0 else None,
                lanes="auto" if small else None,
                allow_raw=True,
            )

        hs = code(hres, CODING_ORDER0)
        ls = code(low, self._low_coding) if has_low else None
        dflags = (0 if has_low else F_NO_LOW) | (spatial << F_SPATIAL_SHIFT)
        out = self.header.serialize() + fpvt.serialize_delta_section(
            dflags, hs, ls
        )
        self._bytes_written = len(out)
        return out

    def encode_batch_bytes(
        self, imgs: np.ndarray, timestamps: np.ndarray | None = None
    ) -> bytes:
        """Encode [B, H, W] uint16 (or, under a shift-8 little-endian
        header, uint8) frames -> one batch section, without recording it
        (see :meth:`add_batch`)."""
        if self._delta_high is None:
            raise RuntimeError("init() must be called first")
        imgs = np.asarray(imgs)
        if imgs.dtype == np.uint8:
            validate_u8_config(self.header.shift, self.header.big_endian)
        with annotate("fpvt.write.upload"):
            dev_imgs = self._put(imgs)
        return self._encode_batch_core(
            dev_imgs, self.header.shift, self.header.big_endian, timestamps,
        )

    def encode_batch_planes_bytes(
        self,
        high: np.ndarray,
        low: np.ndarray | None = None,
        timestamps: np.ndarray | None = None,
    ) -> bytes:
        """Pre-split byte-plane ingest: ``high`` (and optional ``low``) are
        [B, H, W] uint8 planes as the writer's shift config would have split
        them; the bytes equal :meth:`encode_batch_bytes`'s on the combined
        frames."""
        if self._delta_high is None:
            raise RuntimeError("init() must be called first")
        if np.ndim(high) != 3:
            raise ValueError("high must be [B, H, W] uint8")
        with annotate("fpvt.write.upload"):
            imgs = self._put_planes(high, low)
        return self._encode_batch_core(imgs, 0, False, timestamps)

    def encode_batch_planes(
        self,
        high: np.ndarray,
        low: np.ndarray | None = None,
        timestamps: np.ndarray | None = None,
    ) -> bytes:
        """Plane-ingest twin of :meth:`encode_batch` (records the batch)."""
        return self.add_batch(
            self.encode_batch_planes_bytes(high, low, timestamps),
            np.shape(high)[0],
        )

    def _encode_batch_core(
        self,
        imgs: torch.Tensor,
        split_shift: int,
        split_big_endian: bool,
        timestamps: np.ndarray | None,
    ) -> bytes:
        with annotate("fpvt.write.code"):
            flags, streams = self._encode_batch_streams(imgs, split_shift,
                                                        split_big_endian)
        with annotate("fpvt.write.serialize"):
            return self._serialize(flags, streams, timestamps)

    @staticmethod
    def _serialize(flags: np.ndarray, streams, timestamps) -> bytes:
        """A batch section of :meth:`_encode_batch_streams`'s output."""
        if timestamps is None:
            timestamps = np.full(len(flags), -1, dtype=np.int64)
        return fpvt.serialize_batch_section(flags, timestamps, *streams)

    def _encode_batch_streams(
        self,
        imgs: torch.Tensor,
        split_shift: int,
        split_big_endian: bool,
        delta: tuple[torch.Tensor, torch.Tensor] | None = None,
    ):
        """The device work and host packaging of one batch, short of its
        serialization -> (frame flags, (high, low, preview) streams).
        ``delta``: the delta planes on ``imgs``'s device (default: the
        writer's own, on its device)."""
        dh, dl = delta if delta is not None else (self._delta_high,
                                                  self._delta_low)
        b = imgs.shape[0]
        h, w = self.header.ysize, self.header.xsize
        n_main = b * h * w
        if n_main > MAX_DEVICE_SYMS:
            raise ValueError(
                "batch too large for the device codec (2^31 symbols); "
                "use smaller frames_per_batch"
            )
        if not self._narrow or n_main > plane_codec.NARROW_MAX_SYMS:
            flags, (hs, ls, pvs) = fused_encode_batch(
                imgs, dh, dl, split_shift, split_big_endian, self._chunk_len,
                low_coding=self._low_coding, allow_prev=self._allow_prev,
            )
        else:
            m = encode_model_step(
                imgs, dh, dl, split_shift, split_big_endian, True,
                self._low_coding == CODING_CTX16, self._allow_prev,
            )

            def code(name: str, chunk_len: int, coding: int = CODING_ORDER0):
                order0 = coding == CODING_ORDER0
                return encode_plane_batch(
                    m[name].reshape(b, -1),
                    m[f"hist_{name}"].cpu().numpy() if order0 else None,
                    chunk_len,
                    coding=coding,
                    mask=m[f"mask_{name}"].cpu().numpy() if order0 else None,
                    lanes="auto",
                )

            hs = code("high", self._chunk_len)
            pvs = (code("preview", pv_chunk_len(self._chunk_len))
                   if m["preview"].numel() else None)
            ls = code("low", self._chunk_len, self._low_coding)
            flags = _pack_flags(m)
        return flags, (hs, ls, pvs)

    def add_batch(self, section: bytes, nframes: int) -> bytes:
        """Record a section from :meth:`encode_batch_bytes` as the next
        batch in file order; returns the section unchanged."""
        self._batch_offsets.append((self._bytes_written, nframes))
        self._bytes_written += len(section)
        self._total_frames += nframes
        return section

    def encode_batch(
        self, imgs: np.ndarray, timestamps: np.ndarray | None = None
    ) -> bytes:
        """Encode [B, H, W] frames -> the next batch section (recorded)."""
        return self.add_batch(
            self.encode_batch_bytes(imgs, timestamps), np.shape(imgs)[0]
        )

    def finish(self) -> bytes:
        return fpvt.serialize_footer(self._batch_offsets, self._total_frames)


# ---------------------------------------------------------------------------
# decode


def _flag_hints(flags: np.ndarray) -> dict:
    """Which inverse steps a batch's host frame flags ask for: the static
    kwargs of the JAX package's decode programs (any_up, any_cg,
    pv_any_up, pv_any_cg, any_pv_delta, any_prev)."""
    spatial = (flags >> F_SPATIAL_SHIFT) & 3
    pv_spatial = (flags >> F_PV_SPATIAL_SHIFT) & 3
    return dict(
        any_up=bool((spatial == SPATIAL_UP).any()),
        any_cg=bool((spatial == SPATIAL_CG2D).any()),
        pv_any_up=bool((pv_spatial == SPATIAL_UP).any()),
        pv_any_cg=bool((pv_spatial == SPATIAL_CG2D).any()),
        any_pv_delta=bool((flags & F_PV_USE_DELTA).any()),
        any_prev=bool((flags & F_USE_PREV).any()),
    )


def _inverse_spatial(res: torch.Tensor, flags: torch.Tensor, shift: int,
                     any_up: bool, any_cg: bool) -> torch.Tensor:
    """Invert each frame's spatial predictor, its mode 0/1/2 in bits
    ``shift`` and ``shift + 1`` of ``flags`` [B] int32 on ``res``'s
    device, the hints (:func:`_flag_hints`) saying which modes occur: 'up'
    by prefix sum, CG2D by the wavefront (K3), each over the whole batch
    when a frame asks for it and selected per frame, as the JAX package's
    program does."""
    out = res
    if any_up or any_cg:
        mode = flags & (3 << shift)  # compared in place, not shifted down
    if any_up:
        out = _where3(mode == SPATIAL_UP << shift, up_decode(res), out)
    if any_cg:
        out = _where3(mode == SPATIAL_CG2D << shift, cg2d_decode(res), out)
    return out


def _inverse_preview(
    pv: torch.Tensor, flags: torch.Tensor, delta_high: torch.Tensor,
    pv_any_up: bool, pv_any_cg: bool, any_pv_delta: bool,
) -> torch.Tensor:
    """Invert a [B, ph, pw] preview residual batch (``flags`` [B] int32 on
    its device): each frame's spatial prediction, then the delta against
    the delta frame's preview (F_PV_USE_DELTA)."""
    pv = _inverse_spatial(pv, flags, F_PV_SPATIAL_SHIFT, pv_any_up,
                          pv_any_cg)
    if any_pv_delta:
        pv_delta = generate_preview(delta_high[None])
        pv = _where3((flags & F_PV_USE_DELTA) != 0, pv + pv_delta, pv)
    return pv


def _decode_delta_planes(dflags, dh_stream, dl_stream, h, w, device):
    """Decode the delta-section planes -> (high, low) u8 [H, W], inverting
    the high plane's spatial prediction recorded in dflags bits 1-2 (see
    FpvtWriter._init_core); a failed integrity check raises ValueError
    naming the plane."""
    flags = np.array([dflags], np.int32)
    staged = plane_codec.stage_plane_ranges(
        [(n, st, 0, h * w) for n, st in (("high", dh_stream),
                                         ("low", dl_stream))
         if st is not None], device)
    high, low, _pv, coded, ok = _decode_staged(
        staged, ("high", "low"), upload(flags, device), _flag_hints(flags),
        1, h, w, None, None)
    if ok is not None:
        plane_codec.raise_if_bad([f"delta {n}" for n in coded],
                                 ok.cpu().tolist())
    return high[0], low[0]


def _apply_temporal(high, low, flags: torch.Tensor, delta_high, delta_low,
                    any_prev: bool, prev=None):
    """Invert the temporal prediction (``flags`` [B] int32 on the planes'
    device): static delta-add, or, when ``any_prev`` says a frame has
    F_USE_PREV, a mod-256 running sum over frames (frame t adds frame
    t-1's planes), two elementwise launches a frame and plane.  ``prev``:
    the (high, low) [H, W] planes before frame 0, default the delta
    planes (a prev chain decoded from past its anchor follows the planes
    of the frame before it).
    Without delta planes (None: the delta section itself) nothing is
    added."""
    if delta_high is None:
        return high, low
    ud = (flags & F_USE_DELTA) != 0
    if not any_prev:
        return (_where3(ud, high + delta_high[None], high),
                _where3(ud, low + delta_low[None], low))
    up = (flags & F_USE_PREV) != 0
    prev_high, prev_low = prev if prev is not None else (delta_high,
                                                         delta_low)

    def chain(res, delta, prev):
        static = _where3(ud, delta.expand_as(res), 0)  # per-frame delta add
        out = torch.empty_like(res)
        for t in range(res.shape[0]):
            torch.add(res[t], torch.where(up[t], prev, static[t]), out=out[t])
            prev = out[t]
        return out

    return chain(high, delta_high, prev_high), chain(low, delta_low, prev_low)


def _decode_staged(
    staged: plane_codec.StagedRanges, names, flags: torch.Tensor,
    hints: dict, b: int, h: int, w: int, delta_high, delta_low, prev=None,
):
    """The one decode core, from staged plane streams to planes, shared by
    every reader path (batches, prev chains, previews, the delta section)
    and the module-level decode API: one K2 launch for the staged coded
    planes among ``names`` (of "high", "low" and "preview"), then the
    inverse predictions (K3 on CG2D frames and previews), the temporal add
    (:func:`_apply_temporal`, with ``prev``), all queued and nothing waited
    for.  ``flags`` [B] int32 on the device; ``hints``: :func:`_flag_hints`'
    keys (those of the planes asked for).  A low plane asked for but not
    staged is zeros; a missing preview is zeros for frames under 4 x 4,
    else ValueError.  -> (high and low u8 [B, H, W], or None without
    "high"; previews u8 [B, H//4, W//4] or None without "preview"; the
    coded planes' names; a bool tensor of their integrity checks or
    None)."""
    outs, coded, ok = plane_codec.launch_plane_ranges(staged, names)
    high = low = pv = None
    if "high" in names:
        high = _inverse_spatial(outs["high"].reshape(b, h, w), flags,
                                F_SPATIAL_SHIFT, hints["any_up"],
                                hints["any_cg"])
        low = (outs["low"].reshape(b, h, w) if "low" in outs
               else torch.zeros_like(high))
        high, low = _apply_temporal(high, low, flags, delta_high, delta_low,
                                    hints["any_prev"], prev)
    if "preview" in names:
        ph, pw = h // 4, w // 4
        if "preview" in outs:
            pv = _inverse_preview(outs["preview"].reshape(b, ph, pw), flags,
                                  delta_high, hints["pv_any_up"],
                                  hints["pv_any_cg"], hints["any_pv_delta"])
        elif ph * pw == 0:
            pv = torch.zeros((b, ph, pw), dtype=torch.uint8,
                             device=flags.device)
        else:
            raise ValueError("batch has no preview stream")
    return high, low, pv, coded, ok


def _to_u16(high: torch.Tensor, low: torch.Tensor) -> np.ndarray:
    """(high, low) u8 planes -> host uint16 frames (downloaded as 16-bit
    words, waiting for the current stream)."""
    return to_int16(combine_planes(high, low)).cpu().numpy().view(np.uint16)


def _download(tensors, copy_stream, done, into=()):
    """Host copies of device ``tensors`` (None stays None), made on
    ``copy_stream`` once the event ``done`` has passed, into pinned
    memory; waits for ``copy_stream`` alone.  Without a stream (the CPU)
    the tensors themselves.  ``into``: host tensors, one per leading
    tensor (None for none), that those are copied into and returned as,
    on either device."""
    into = list(into) + [None] * (len(tensors) - len(into))
    if copy_stream is None:
        return [t if d is None else d.copy_(t) for t, d in zip(tensors, into)]
    with torch.cuda.stream(copy_stream):
        copy_stream.wait_event(done)
        host = [None if t is None
                else t.to("cpu", non_blocking=True) if d is None
                else d.copy_(t, non_blocking=True)
                for t, d in zip(tensors, into)]
    copy_stream.synchronize()
    return host


def _check_batch_size(pb: fpvt.ParsedBatch) -> None:
    if len(pb.frame_flags) * pb.high.plane_size > MAX_DEVICE_SYMS:
        raise ValueError("batch too large for the device codec (2^31 symbols)")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device.  A CUDA device needs a card: without
    one this raises rather than running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but PyTorch sees no "
                           "CUDA device; pass device='cpu' for the CPU")
    return dev


# ---------------------------------------------------------------------------
# the module-level device decode API (the JAX package's decode programs:
# the same names, arguments and outputs, on torch tensors)


def section_rows_need(pb: fpvt.ParsedBatch, chunk_len: int) -> int:
    """Decode-window rows a parsed batch needs: the JAX package's
    ``rows_alloc`` lower bound (shared by :func:`batch_decode_args` and
    the sharded decode's grouping pass)."""
    return max(
        (plane_codec._quantize_rows(int(st.block_counts.max()), st.chunk_len)
         for st in (pb.high, pb.low, pb.preview)
         if st.coding != CODING_CONST and st.block_counts.size),
        default=0,
    ) + 16


def _fused_decodable(pb: fpvt.ParsedBatch, chunk_len: int) -> bool:
    """The JAX package's test for a section its sharded program decodes:
    every plane stream present, and CONST, RAW or coded with 1024 lanes
    (main planes at the header's chunk length, the preview at any
    segment-compatible one).  Narrow streams go to the single-device
    reader."""
    for st, is_pv in ((pb.high, False), (pb.low, False), (pb.preview, True)):
        if st is None:
            return False
        if st.coding in (CODING_CONST, CODING_RAW):
            continue
        if st.lanes != BLOCK_LANES:
            return False
        if is_pv:
            if st.chunk_len > SEG_LEN and st.chunk_len % SEG_LEN:
                return False
        elif st.chunk_len != chunk_len:
            return False
    return True


def batch_decode_args(
    pb: fpvt.ParsedBatch, chunk_len: int, *, rows_alloc: int | None = None
) -> tuple[dict, dict]:
    """:func:`fused_decode_batch`'s inputs from a parsed batch ->
    ``(arrays, static)``, equal to the JAX package's.

    ``arrays``: numpy payload (every non-CONST plane's words, concatenated,
    then zero slack), plane_offs, counts and states (of the coded planes),
    flags, sym_tabs [3, 32, 128] (fused decode tables), fcs (unread) and
    const_vals.  ``static``: rows_alloc, pv_chunk_len, low_ctx,
    const_planes, raw_planes and the ``any_*`` hints.  ``rows_alloc``
    overrides the window allocation (ValueError below this section's need)
    so stacked sections share one shape, as the sharded decode stacks
    them.  The arrays describe 1024-lane streams only: a section with a
    missing or narrow stream raises ValueError (decode it with
    :class:`FpvtReader`)."""
    streams = [pb.high, pb.low, pb.preview]
    _check_batch_size(pb)
    if not _fused_decodable(pb, chunk_len):
        raise ValueError("batch_decode_args takes sections of 1024-lane, "
                         "CONST or RAW streams at the file's chunk length")
    const_planes = tuple(st.coding == CODING_CONST for st in streams)
    raw_planes = tuple(st.coding == CODING_RAW for st in streams)
    const_vals = np.array(
        [st.value if c else 0 for st, c in zip(streams, const_planes)],
        np.uint32)
    coded = [st for st, c, r in zip(streams, const_planes, raw_planes)
             if not (c or r)]
    need_rows = section_rows_need(pb, chunk_len)
    if rows_alloc is None:
        rows_alloc = need_rows
    elif rows_alloc < need_rows:
        raise ValueError("rows_alloc override below this section's need")
    win = rows_alloc * BLOCK_COLS
    plane_offs = np.zeros(3, np.int32)
    parts, pos = [], 0
    for i, st in enumerate(streams):
        plane_offs[i] = pos
        if not const_planes[i]:
            parts.append(st.payload)
            pos += st.payload.size
    cap = plane_codec._quantize_cap(
        pos + win, chunk_len, max(sum(s.num_blocks for s in coded), 1))
    payload = np.zeros(cap + win, np.uint16)
    payload[:pos] = np.concatenate(parts) if parts else payload[:0]
    counts = np.concatenate([s.block_counts for s in coded]
                            or [np.zeros(0, np.uint32)]).astype(np.uint32)
    states = np.concatenate([s.states for s in coded]
                            or [np.zeros(0, np.uint32)]).astype(np.uint32)
    fcs = np.zeros((3, 4, BLOCK_COLS), np.uint32)
    sym_tabs = np.zeros((3, 32, BLOCK_COLS), np.uint32)
    for i, st in enumerate(streams):
        if not (const_planes[i] or raw_planes[i]):
            tab = (rans_cuda.ctx_fused_table_arrays(st.freq)
                   if st.coding == CODING_CTX16
                   else rans_cuda.fused_table_arrays(st.freq))
            sym_tabs[i] = tab.reshape(32, BLOCK_COLS)
    arrays = dict(payload=payload, plane_offs=plane_offs, counts=counts,
                  states=states, flags=pb.frame_flags.astype(np.uint32),
                  sym_tabs=sym_tabs, fcs=fcs, const_vals=const_vals)
    static = dict(rows_alloc=rows_alloc,
                  pv_chunk_len=int(pb.preview.chunk_len),
                  low_ctx=bool(pb.low.coding == CODING_CTX16),
                  const_planes=const_planes, raw_planes=raw_planes,
                  **_flag_hints(pb.frame_flags))
    return arrays, static


def _arg_device(args, device) -> torch.device:
    """``device`` if given, else the first tensor argument's device, else
    the card (:func:`resolve_device`)."""
    if device is None:
        device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                      "cuda")
    return resolve_device(device)


def _on(a, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``a`` (numpy or a tensor) on ``dev`` as ``dtype``: reinterpreted bit
    for bit where the item sizes agree (u32 -> int32, u16 -> int16), else
    converted.  Numpy goes up through pinned memory; nothing waits."""
    if not isinstance(a, torch.Tensor):
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:  # torch wants a writable array to share
            a = a.copy()
        size = torch.empty(0, dtype=dtype).element_size()
        a = torch.from_numpy(a.view(f"<i{size}") if a.dtype.itemsize == size
                             and a.dtype.kind in "iu" else a)
        if dev.type == "cuda":
            a = a.pin_memory()
    a = a.to(dev, non_blocking=True)
    if a.dtype == dtype:
        return a
    if a.element_size() == torch.empty(0, dtype=dtype).element_size():
        return a.view(dtype)
    return a.to(dtype)


def _decode_plane(counts: torch.Tensor, base, states: torch.Tensor,
                  lens: torch.Tensor, chunk_len: int, table: torch.Tensor,
                  payload: torch.Tensor, ctx: bool) -> rans_cuda.DecodePlane:
    """K2's inputs for one 1024-lane plane (``lens`` [nblocks, 1024])
    whose groups' words start at ``base`` (an int or a device scalar) in
    the staged ``payload``."""
    c64 = counts.to(torch.int64)
    return rans_cuda.DecodePlane(
        counts, base + torch.cumsum(c64, 0) - c64,
        states.view(-1, BLOCK_LANES), lens, table.reshape(-1), payload,
        chunk_len, CTX_PROB_BITS if ctx else PROB_BITS, ctx)


_LENS: dict = {}


def _lens(b: int, s: int, chunk_len: int, dev: torch.device) -> torch.Tensor:
    """Lane lengths of a 1024-lane plane batch on ``dev``, made once per
    geometry (the decode calls then upload nothing for them)."""
    key = (b, s, chunk_len, dev)
    if key not in _LENS:
        _LENS[key] = lens_tensor(b, s, chunk_len, dev)
    return _LENS[key]


def fused_decode_batch(
    payload, plane_offs, counts, states, flags, sym_tabs, fcs, delta_high,
    delta_low, const_vals, *, chunk_len: int, b: int, h: int, w: int,
    any_up: bool, any_cg: bool, pv_any_up: bool, pv_any_cg: bool,
    decode_preview: bool = False, rows_alloc: int | None = None,
    low_ctx: bool = False, const_planes: tuple = (False, False, False),
    any_pv_delta: bool = False, pack_u8: bool = False,
    any_prev: bool = False, raw_planes: tuple = (False, False, False),
    pv_chunk_len: int | None = None, device=None,
):
    """Whole-batch FPVT decode on the device from
    :func:`batch_decode_args`' arrays -> ``(imgs, ok)``, or ``(imgs, ok,
    pv)`` with ``decode_preview``.

    ``imgs``: int32 [B, H, W] holding the u16 values (the reader's
    ``device_frames``), or with ``pack_u8`` their little-endian byte
    stream u8 [B*H, 2W] (the JAX package's layout; view as ``<u2`` on the
    host).  ``ok``: a 0-d bool tensor of every rANS integrity check,
    left on the device.  ``pv``: u8 [B, H//4, W//4].

    Inputs are numpy arrays (uploaded to ``device``, default the card) or
    tensors (kept on their device).  One K2 launch decodes every coded
    plane (the preview too with ``decode_preview``) through the reader's
    own path (:func:`_decode_staged`); CONST planes fill from
    ``const_vals`` and RAW planes unpack from ``payload`` at
    ``plane_offs``; then the inverse predictions (K3 on CG2D frames and
    previews), the temporal add and the plane combine.  Nothing waits for
    the device.  The ``any_*`` hints select the inverse steps as in the
    JAX program (a step a hint leaves out is not run); ``rows_alloc`` and
    ``fcs`` exist for the JAX program's shapes and are not read."""
    dev = _arg_device((payload, flags, delta_high), device)
    pay = rans_cuda.staged_payload(_on(payload, dev, torch.int16).reshape(-1))
    offs = _on(plane_offs, dev, torch.int32).to(torch.int64)
    counts = _on(counts, dev, torch.int32)
    states = _on(states, dev, torch.int32)
    tabs = _on(sym_tabs, dev, torch.int32)
    cvals = _on(const_vals, dev, torch.int32)
    pv_k = pv_chunk_len or chunk_len
    geoms = [(h * w, chunk_len), (h * w, chunk_len),
             ((h // 4) * (w // 4), pv_k)]
    names = ["high", "low", "preview"][: 3 if decode_preview else 2]
    direct, jobs, coded, where = [], [], [], []
    coff = soff = 0
    for pi, name in enumerate(names):
        s, k_p = geoms[pi]
        n = b * s
        if const_planes[pi]:
            direct.append(cvals[pi].to(torch.uint8).expand(n))
            continue
        if raw_planes[pi]:
            n2 = -(-n // 2)
            start = offs[pi].clamp(0, max(pay.numel() - n2, 0))
            words = pay[start + torch.arange(n2, device=dev)].to(torch.int32)
            byts = torch.stack([words & 0xFF, (words >> 8) & 0xFF], dim=-1)
            direct.append(byts.reshape(-1)[:n].to(torch.uint8))
            continue
        nb = num_blocks(b, s, k_p, BLOCK_LANES)
        ngroups = nb * num_segments(k_p)
        jobs.append(_decode_plane(
            counts[coff : coff + ngroups], offs[pi],
            states[soff : soff + nb * BLOCK_LANES], _lens(b, s, k_p, dev),
            k_p, tabs[pi], pay, low_ctx and pi == 1))
        coff += ngroups
        soff += nb * BLOCK_LANES
        direct.append(None)
        coded.append(name)
        where.append((pi, 0, n))
    staged = plane_codec.StagedRanges(
        names, direct,
        plane_codec.StagedBlocks(coded, jobs) if jobs else None, where)
    hints = dict(any_up=any_up, any_cg=any_cg, pv_any_up=pv_any_up,
                 pv_any_cg=pv_any_cg, any_pv_delta=any_pv_delta,
                 any_prev=any_prev)
    high, low, pv, _coded, ok = _decode_staged(
        staged, names, _on(flags, dev, torch.int32), hints, b, h, w,
        _on(delta_high, dev, torch.uint8), _on(delta_low, dev, torch.uint8))
    imgs = combine_planes(high, low)
    ok = ok.all() if ok is not None else torch.ones((), dtype=torch.bool,
                                                    device=dev)
    if pack_u8:
        imgs = torch.stack([imgs & 0xFF, imgs >> 8], dim=-1).to(
            torch.uint8).reshape(b * h, 2 * w)
    if not decode_preview:
        return imgs, ok
    return imgs, ok, pv


def fused_decode_frame(
    pay_h, cnt_h, st_h, lens_h, off_h, pay_l, cnt_l, st_l, lens_l, off_l,
    sym_h, fc_h, sym_l, fc_l, delta_high, delta_low, *, chunk_len: int,
    h: int, w: int, nbh: int, nbl: int, spatial: int, use_delta: bool,
    no_low: bool, low_ctx: bool, rows_h: int, rows_l: int, device=None,
):
    """ONE frame from only its covering rANS blocks -> ``(img, ok)``: int32
    [H, W] u16 values and a 0-d bool tensor, on the device.

    The arguments are the JAX package's (what its reader builds for a
    frame): per plane the covering blocks' payload words, (block, segment)
    counts, states, lane lengths [nb, 8, 128] and the frame's first symbol
    within them, then the fused tables.  One K2 launch decodes both planes
    (the high plane alone with ``no_low``), K3 runs on a CG2D frame;
    ``use_delta`` adds ``delta_high``/``delta_low`` (the previous frame's
    planes for F_USE_PREV).  ``fc_*`` and ``rows_*`` are not read."""
    dev = _arg_device((pay_h, cnt_h, delta_high), device)
    planes = [(pay_h, cnt_h, st_h, lens_h, sym_h, off_h, False)]
    if not no_low:
        planes.append((pay_l, cnt_l, st_l, lens_l, sym_l, off_l, low_ctx))
    names = ["high", "low"][: len(planes)]
    jobs = [_decode_plane(
        _on(cnt, dev, torch.int32), 0, _on(st, dev, torch.int32),
        _on(lens, dev, torch.int32).reshape(-1, BLOCK_LANES), chunk_len,
        _on(sym, dev, torch.int32),
        rans_cuda.staged_payload(_on(pay, dev, torch.int16).reshape(-1)), ctx)
        for pay, cnt, st, lens, sym, _off, ctx in planes]
    staged = plane_codec.StagedRanges(
        names, [None] * len(jobs), plane_codec.StagedBlocks(names, jobs),
        [(i, int(p[5]), h * w) for i, p in enumerate(planes)])
    flags = np.array([(spatial << F_SPATIAL_SHIFT)
                      | (F_USE_DELTA if use_delta else 0)], np.int32)
    dl = _on(delta_low, dev, torch.uint8)
    if no_low:  # the low plane stays zeros, as in the JAX program
        dl = torch.zeros_like(dl)
    high, low, _pv, _coded, ok = _decode_staged(
        staged, ("high", "low"), upload(flags, dev), _flag_hints(flags), 1,
        h, w, _on(delta_high, dev, torch.uint8), dl)
    return combine_planes(high, low)[0], ok.all()


def fused_decode_preview(
    payload, counts, states, flags, sym_tab, fc, delta_high, *,
    chunk_len: int, b: int, ph: int, pw: int, pv_any_up: bool,
    pv_any_cg: bool, rows_alloc: int, any_pv_delta: bool = False,
    device=None,
):
    """A batch's previews alone -> ``(pv, ok)``: u8 [B, ph, pw] and a 0-d
    bool tensor, on the device, from the JAX reader's arguments (the
    preview stream's payload, counts, states, the frame flags and its
    fused table).  One K2 launch, then the inverse spatial prediction (K3
    on CG2D previews) and the delta frame's preview where F_PV_USE_DELTA
    says.  ``fc`` and ``rows_alloc`` are not read."""
    dev = _arg_device((payload, counts, delta_high), device)
    job = _decode_plane(
        _on(counts, dev, torch.int32), 0, _on(states, dev, torch.int32),
        _lens(b, ph * pw, chunk_len, dev), chunk_len,
        _on(sym_tab, dev, torch.int32),
        rans_cuda.staged_payload(_on(payload, dev, torch.int16).reshape(-1)),
        False)
    staged = plane_codec.StagedRanges(
        ["preview"], [None], plane_codec.StagedBlocks(["preview"], [job]),
        [(0, 0, b * ph * pw)])
    hints = dict(pv_any_up=pv_any_up, pv_any_cg=pv_any_cg,
                 any_pv_delta=any_pv_delta)
    _h, _l, pv, _coded, ok = _decode_staged(
        staged, ("preview",), _on(flags, dev, torch.int32), hints, b, 4 * ph,
        4 * pw, _on(delta_high, dev, torch.uint8), None)
    return pv, ok.all()


def _frame_decode_args(pb: fpvt.ParsedBatch, j: int, h: int, w: int,
                       chunk_len: int) -> tuple[tuple, dict]:
    """:func:`fused_decode_frame`'s arguments for frame ``j`` of a parsed
    batch of 1024-lane coded planes, as the JAX package's reader builds
    them (``_decode_frame_blocks``) -> (the fourteen arrays before the
    delta planes, the keyword arguments).  The caller passes the delta
    planes: the file's, or the previous frame's planes for F_USE_PREV."""
    if not all(st.coding in (CODING_ORDER0, CODING_CTX16)
               and st.lanes == BLOCK_LANES and st.chunk_len == chunk_len
               for st in (pb.high, pb.low)):
        raise ValueError("fused_decode_frame takes coded 1024-lane high and "
                         "low planes at the file's chunk length")
    s, k = h * w, chunk_len
    span, nseg = k * BLOCK_LANES, num_segments(k)
    lens_all = chunk_lens(len(pb.frame_flags), s, k).reshape(-1, BLOCK_LANES)

    def prep(st):
        counts = st.block_counts.astype(np.int64)
        cum = np.concatenate([[0], np.cumsum(counts)])
        b0, b1 = (j * s) // span, ((j + 1) * s - 1) // span
        nb = b1 - b0 + 1
        cnt = counts[b0 * nseg : (b1 + 1) * nseg].astype(np.int32)
        rows = plane_codec._quantize_rows(int(cnt.max()), k) + 16
        total = int(cnt.sum())
        pay = np.zeros(plane_codec._quantize_cap(total, k, nb)
                       + rows * BLOCK_COLS, np.uint16)
        pay[:total] = st.payload[cum[b0 * nseg] : cum[(b1 + 1) * nseg]]
        tab = (rans_cuda.ctx_fused_table_arrays(st.freq)
               if st.coding == CODING_CTX16
               else rans_cuda.fused_table_arrays(st.freq))
        return ((pay, cnt, st.states[b0 * BLOCK_LANES : (b1 + 1) * BLOCK_LANES]
                 .astype(np.uint32), lens_all[b0 : b1 + 1].reshape(nb, 8, -1),
                 np.int32(j * s - b0 * span)),
                (tab.reshape(32, BLOCK_COLS),
                 np.zeros((2, BLOCK_COLS), np.uint32)), nb, rows)

    (ah, th, nbh, rows_h), (al, tl, nbl, rows_l) = prep(pb.high), prep(pb.low)
    flags = int(pb.frame_flags[j])
    return (*ah, *al, *th, *tl), dict(
        chunk_len=k, h=h, w=w, nbh=nbh, nbl=nbl,
        spatial=(flags >> F_SPATIAL_SHIFT) & 3,
        use_delta=bool(flags & (F_USE_DELTA | F_USE_PREV)), no_low=False,
        low_ctx=pb.low.coding == CODING_CTX16, rows_h=rows_h, rows_l=rows_l)


def _preview_decode_args(pb: fpvt.ParsedBatch, h: int, w: int
                         ) -> tuple[tuple, dict]:
    """:func:`fused_decode_preview`'s arguments for a parsed batch's coded
    1024-lane preview stream, as the JAX package's reader builds them ->
    (the six arrays before the delta high plane, the keyword
    arguments)."""
    st, flags = pb.preview, pb.frame_flags
    if st is None or st.coding != CODING_ORDER0 or st.lanes != BLOCK_LANES:
        raise ValueError("fused_decode_preview takes a coded 1024-lane "
                         "preview stream")
    k = st.chunk_len
    counts = st.block_counts.astype(np.int32)
    rows = plane_codec._quantize_rows(int(counts.max()), k) + 16
    payload = np.zeros(plane_codec._quantize_cap(int(counts.sum()), k,
                                                 st.num_blocks)
                       + rows * BLOCK_COLS, np.uint16)
    payload[: st.payload.size] = st.payload
    hints = _flag_hints(flags)
    return (payload, counts, st.states.astype(np.uint32),
            flags.astype(np.uint32),
            rans_cuda.fused_table_arrays(st.freq).reshape(32, BLOCK_COLS),
            np.zeros((2, BLOCK_COLS), np.uint32)), dict(
        chunk_len=k, b=len(flags), ph=h // 4, pw=w // 4,
        pv_any_up=hints["pv_any_up"], pv_any_cg=hints["pv_any_cg"],
        rows_alloc=rows, any_pv_delta=hints["any_pv_delta"])


def _section_key(section, header: Header) -> tuple:
    """Upload-cache key of a batch section's bytes in a file of this
    geometry."""
    return ("sec", hashlib.blake2b(section, digest_size=16).digest(),
            header.ysize, header.xsize, header.chunk_log2)


@dataclasses.dataclass
class _StagedBatch:
    """A batch section's decode inputs on its device, as the upload cache
    keeps them: the staged plane streams (high, low and preview, as the
    section has them), the host frame flags and timestamps, the frame
    count, an event marking the end of the uploads (None on the CPU) and
    the flags on the device."""

    planes: plane_codec.StagedRanges
    flags: np.ndarray
    timestamps: np.ndarray
    b: int
    device: torch.device
    ready: object
    dev_flags: torch.Tensor


class FpvtReader:
    """Random-access FPVT reader: batches, single frames and previews
    decode on ``device``.

    On a CUDA device the reader queues its uploads (from pinned memory),
    kernels and elementwise work on an issue stream of its own and copies
    batches to the host on a second stream, so a batch's download can
    overlap the next batch's upload and decode (:meth:`_issue`)."""

    def __init__(
        self, data: bytes, device="cuda", upload_cache: dict | None = None
    ) -> None:
        """``upload_cache``: optional dict, caller-owned and caller-bounded
        (its entries hold device memory), staging batch uploads on the
        device by the section bytes' hash; share one dict across readers
        to stage a replayed or multicast file once."""
        with annotate("fpvt.read.open"):
            self._data = bytes(data)
            self._open(self._data, device, upload_cache)
            self._batches = fpvt.parse_footer(self._data)
            # the footer's counts size the frame index: hold them to their
            # sections first (a crafted count would claim millions of
            # frames)
            fpvt.check_footer_counts(self._data, self._batches)
            self._frame_to_batch: list[tuple[int, int]] = []
            if self.header.delta_is_frame0:
                # frame 0 is the delta frame itself (HDR_F_DELTA_IS_FRAME0)
                self._frame_to_batch.append((-1, 0))
            for bi, (_off, n) in enumerate(self._batches):
                self._frame_to_batch.extend((bi, j) for j in range(n))

    def _open(self, data: bytes, device, upload_cache=None) -> None:
        """Parse the header and decode the delta section (the part of the
        reader the streaming reader shares)."""
        self._device = resolve_device(device)
        cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if cuda else None
        self._copy_stream = torch.cuda.Stream(self._device) if cuda else None
        self._upload_cache = upload_cache
        self.header = Header.parse(data)
        h, w = self.header.ysize, self.header.xsize
        dflags, dh_stream, dl_stream = fpvt.parse_delta_section(
            data, fpvt.HEADER_SIZE, plane_size=h * w
        )
        with self._on_stream():
            self._delta_high, self._delta_low = _decode_delta_planes(
                dflags, dh_stream, dl_stream, h, w, self._device
            )
        # the last whole batch decoded: (batch index, frames)
        self._cache: tuple[int, np.ndarray] | None = None
        # the last frame a prev chain reconstructed: (batch index, frame
        # index, high, low), so sequential decode_frame calls continue the
        # chain instead of re-decoding its prefix
        self._chain_cache: tuple | None = None

    def _on_stream(self):
        """Context queuing this reader's device work on its issue stream
        (no-op on the CPU)."""
        return torch.cuda.stream(self._stream)

    def _replica(self, device) -> FpvtReader:
        """A reader of the same file on ``device`` with issue and copy
        streams of its own, sharing this reader's parsed index and upload
        cache; its delta planes are copies of this reader's (no kernel
        runs).  One reader per mesh shard lets shards on one card decode
        side by side."""
        dev = resolve_device(device)
        r = FpvtReader.__new__(FpvtReader)
        r.__dict__.update(self.__dict__)
        cuda = dev.type == "cuda"
        r._device = dev
        r._stream = torch.cuda.Stream(dev) if cuda else None
        r._copy_stream = torch.cuda.Stream(dev) if cuda else None
        r._cache = r._chain_cache = None
        if self._stream is not None:
            self._stream.synchronize()  # the delta planes are decoded
        with r._on_stream():
            r._delta_high = self._delta_high.to(dev)
            r._delta_low = self._delta_low.to(dev)
        return r

    def _parse_batch(self, off: int, data=None) -> fpvt.ParsedBatch:
        """parse_batch_section of the section at ``off`` in ``data``
        (default the file) with this file's frame geometry enforced
        (crafted plane_size fields are rejected before any allocation)."""
        h, w = self.header.ysize, self.header.xsize
        with annotate("fpvt.read.parse"):
            return fpvt.parse_batch_section(
                self._data if data is None else data, off,
                plane_size=h * w, preview_size=(h // 4) * (w // 4),
            )

    def frame0(self) -> np.ndarray:
        """The synthesized first frame when the header declares the delta
        frame doubles as frame 0 (left-aligned u16, like decode_batch)."""
        return self.delta_frame()

    def delta_frame(self) -> np.ndarray:
        """The file's delta frame (left-aligned uint16 [H, W]), the frame
        every batch's delta prediction references."""
        with self._on_stream():
            return _to_u16(self._delta_high[None], self._delta_low[None])[0]

    @property
    def numframes(self) -> int:
        return len(self._frame_to_batch)

    @property
    def num_batches(self) -> int:
        return len(self._batches)

    def timestamps(self, index: int) -> np.ndarray:
        """Batch ``index``'s per-frame i64 timestamps (-1 where none)."""
        off, _b = self._batches[index]
        return self._parse_batch(off).timestamps.copy()

    def _issue(self, batch, want_previews: bool = False,
               device_frames: bool = False, key=None):
        """Issue one batch's decode, returning ``finalize(into=None) ->
        (frames, previews or None)``, whose ``timestamps`` attribute holds
        the batch's i64 timestamps.

        ``batch``: the index of one of this file's batches, ``(buffer,
        offset)`` of a batch section in a buffer the caller holds (the
        streaming reader's), or a parsed batch (never cached).  With an
        upload cache, a section's staged inputs (with its flags,
        timestamps and frame count) are kept under ``key``, default a hash
        of its bytes (:func:`_section_key`): a section staged under it on
        this reader's device skips the parse and the uploads, and an entry
        on another device is replaced.  The delta planes and streams are
        this reader's, so readers of different delta frames share only the
        staged batch inputs.

        The issue step queues all the batch's device work and waits for
        none of it: the uploads (:func:`plane_codec.stage_plane_ranges`),
        one K2 launch for the high and low planes (and the preview plane
        with ``want_previews``), the inverse predictions (K3 on CG2D
        frames and previews), the temporal add and the plane combine
        (:func:`_decode_staged`).  Every plane stream decodes by its own
        coding and geometry (wide, narrow, const or raw).  ``finalize``
        waits for that work alone, on the reader's copy stream: it reads
        the integrity checks (a failed one raises ValueError naming the
        plane) and copies frames and previews into pinned host memory ->
        u16 [B, H, W] and u8 [B, H//4, W//4] numpy arrays (a new buffer
        per batch; ``finalize(into)`` downloads the frames into the host
        int16 [B, H, W] tensor ``into`` instead and returns a view of it,
        as :func:`decode_file_fpvt` does with its output's slices).

        ``device_frames``: finalize reads only the integrity checks and
        returns the device tensors: frames int32 [B, H, W] holding the
        u16 values (what ``combine_planes`` gives; torch has no full
        uint16 support), previews uint8 [B, H//4, W//4].  They are
        recorded on the finalizing thread's current stream, so that thread
        may use and free them there."""
        staged = pb = None
        if isinstance(batch, fpvt.ParsedBatch):
            pb, key = batch, None
        else:
            buf, off = (batch if isinstance(batch, tuple)
                        else (self._data, self._batches[batch][0]))
            if self._upload_cache is None:
                key = None
            else:
                if key is None:
                    (size,) = struct.unpack_from("<Q", buf, off)
                    key = _section_key(memoryview(buf)[off : off + size],
                                       self.header)
                staged = self._upload_cache.get(key)
                if staged is not None and staged.device != self._device:
                    staged = None
        if staged is None:
            if pb is None:
                pb = self._parse_batch(off, buf)
            staged = self._stage(pb)
            if key is not None:
                self._upload_cache[key] = staged
        return self._dispatch(staged, want_previews, device_frames)

    def _stage(self, pb: fpvt.ParsedBatch) -> _StagedBatch:
        """Upload a parsed batch's plane streams (the preview's too)."""
        _check_batch_size(pb)
        requests = [(name, st, 0, st.nframes * st.plane_size)
                    for name, st in (("high", pb.high), ("low", pb.low),
                                     ("preview", pb.preview))
                    if st is not None]
        with annotate("fpvt.read.stage"), self._on_stream():
            planes = plane_codec.stage_plane_ranges(requests, self._device)
            dev_flags = upload(pb.frame_flags.astype(np.int32), self._device)
            ready = None
            if self._stream is not None:
                ready = torch.cuda.Event()
                ready.record(self._stream)
        # copies: a parse of the file's bytes gives views, which would keep
        # the whole file alive in the upload cache
        return _StagedBatch(planes, pb.frame_flags.copy(),
                            pb.timestamps.copy(), len(pb.frame_flags),
                            self._device, ready, dev_flags)

    def _dispatch(self, st: _StagedBatch, want_previews: bool,
                  device_frames: bool):
        """Queue a staged batch's decode (see :meth:`_issue`) ->
        finalize."""
        h, w = self.header.ysize, self.header.xsize
        names = ("high", "low", "preview")[: 3 if want_previews else 2]
        with annotate("fpvt.read.dispatch"), self._on_stream():
            if st.ready is not None:
                # the inputs may have been staged on another reader's stream
                self._stream.wait_event(st.ready)
            high, low, pv, coded, ok = _decode_staged(
                st.planes, names, st.dev_flags, _flag_hints(st.flags), st.b,
                h, w, self._delta_high, self._delta_low)
            if want_previews:
                direct = dict(zip(st.planes.names, st.planes.direct))
                kept = direct.get("preview")
                if device_frames and kept is not None and (
                        pv.data_ptr() == kept.data_ptr()):
                    pv = pv.clone()  # never hand out the cache's own bytes
            return self._finish(combine_planes(high, low), pv, coded, ok,
                                device_frames, st.timestamps, keep=st)

    def _issued(self):
        """An event past the work queued so far on the issue stream (None
        on the CPU)."""
        if self._stream is None:
            return None
        done = torch.cuda.Event()
        done.record(self._stream)
        return done

    def _finish(self, frames, pv, coded, ok, device_frames: bool,
                timestamps: np.ndarray, keep=None):
        """``finalize`` of work queued on the issue stream: ``frames``
        int32 [B, H, W] u16 values, ``pv`` u8 previews or None, ``coded``
        the names of the rANS-decoded planes and ``ok`` their integrity
        checks (None when there are none), ``timestamps`` the batch's
        (``finalize.timestamps``).  Runs on the issue stream.  ``keep``:
        staged inputs the queued work reads, held until it has run."""
        if not device_frames:
            frames = to_int16(frames)
        done = self._issued()
        copy, dev = self._copy_stream, self._device
        refs = [frames, pv, ok, keep]

        def finalize(into=None):
            with annotate("fpvt.read.finalize"):
                frames, pv, ok, _keep = refs
                refs.clear()
                host = _download(
                    [ok] if device_frames else [ok, frames, pv], copy, done,
                    [None, into])
                if ok is not None:
                    plane_codec.raise_if_bad(coded, host[0].tolist())
                if device_frames:
                    if copy is not None:
                        cur = torch.cuda.current_stream(dev)
                        for t in (frames, pv):
                            if t is not None:
                                t.record_stream(cur)
                    return frames, pv
                return (host[1].numpy().view(np.uint16),
                        None if pv is None else host[2].numpy())

        finalize.timestamps = timestamps
        return finalize

    def _frame0_issue(self, want_previews: bool, device_frames: bool):
        """finalize for the synthesized frame 0 (the delta frame) as a
        batch of one, with its preview made from the delta high plane."""
        with self._on_stream():
            pv = (generate_preview(self._delta_high[None]) if want_previews
                  else None)
            return self._finish(
                combine_planes(self._delta_high[None], self._delta_low[None]),
                pv, [], None, device_frames, np.full(1, -1, np.int64))

    def _frame0_into(self, dst: torch.Tensor) -> None:
        """Download the synthesized frame 0 (the delta frame) into the
        host int16 [1, H, W] tensor ``dst`` on the copy stream."""
        with self._on_stream():
            f = to_int16(combine_planes(self._delta_high[None],
                                        self._delta_low[None]))
            done = self._issued()
        _download([f], self._copy_stream, done, [dst])

    def _download_checked(self, t: torch.Tensor, coded, ok) -> torch.Tensor:
        """A host copy of ``t``, queued on the issue stream, once the
        integrity checks ``ok`` (None: none) of the planes named in
        ``coded`` pass, in one wait; a failed one raises ValueError naming
        the plane."""
        host = _download([t, ok], self._copy_stream, self._issued())
        if ok is not None:
            plane_codec.raise_if_bad(coded, host[1].tolist())
        return host[0]

    def decode_batch(self, index: int) -> np.ndarray:
        """Decode batch ``index`` -> [B, H, W] uint16 (left-aligned values)."""
        return self._issue(index)()[0]

    def decode_frame(self, index: int) -> np.ndarray:
        """Random-access decode of ONE frame by global frame index ->
        [H, W] uint16 (left-aligned).

        Serves from the batch cache when its batch was decoded last;
        otherwise, for 1024-lane streams, decodes only the rANS blocks
        covering the frame's prev-frame chain, from its anchor (the writer
        bounds chains to PREV_ANCHOR - 1 frames) or from the last frame
        decoded when that one is earlier in the same chain: the chain's
        frames are one symbol range a plane, staged once (the union of
        their covering blocks, each block once) and run through
        :func:`_decode_staged` as one batch, one K2 launch for the high
        and low blocks, and the integrity checks are read once, with the
        answer.  A narrow stream is one block (NARROW_MAX_K * lanes covers
        a whole narrow batch), and a chain beyond 2 * PREV_ANCHOR frames
        costs more than its batch: both decode the whole batch and cache
        it instead."""
        bi, j = self._frame_to_batch[index]
        if bi == -1:
            with annotate("fpvt.read.download"):
                return self.frame0()
        if self._cache is not None and self._cache[0] == bi:
            return self._cache[1][j]
        pb = self._parse_batch(self._batches[bi][0])
        j0 = j
        while j0 > 0 and pb.frame_flags[j0] & F_USE_PREV:
            j0 -= 1
        wide = all(
            st.coding in (CODING_CONST, CODING_RAW) or st.lanes == BLOCK_LANES
            for st in (pb.high, pb.low) if st is not None
        )
        if not wide or j - j0 > 2 * PREV_ANCHOR:
            self._cache = (bi, self._issue(pb)()[0])
            return self._cache[1][j]
        _check_batch_size(pb)
        h, w = self.header.ysize, self.header.xsize
        s = h * w
        t0, prev = j0, None
        cc = self._chain_cache
        if cc is not None and cc[0] == bi and j0 <= cc[1] < j:
            t0, prev = cc[1] + 1, cc[2]
        with self._on_stream():
            with annotate("fpvt.read.chain"):
                flags = pb.frame_flags[t0 : j + 1]
                staged = plane_codec.stage_plane_ranges(
                    [(n, st, t0 * s, (j + 1) * s)
                     for n, st in (("high", pb.high), ("low", pb.low))
                     if st is not None], self._device)
                high, low, _pv, coded, ok = _decode_staged(
                    staged, ("high", "low"),
                    upload(flags.astype(np.int32), self._device),
                    _flag_hints(flags), len(flags), h, w, self._delta_high,
                    self._delta_low, prev)
            with annotate("fpvt.read.download"):
                frame = self._download_checked(
                    to_int16(combine_planes(high[-1:], low[-1:])), coded, ok)
                self._chain_cache = (bi, j, (high[-1], low[-1]))
                return frame.numpy().view(np.uint16)[0]

    def decode_batch_with_previews(
        self, index: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Decode batch ``index``'s frames and previews."""
        return self._issue(index, want_previews=True)()

    def preview_frame(self, index: int) -> np.ndarray:
        """Preview of ONE frame by global frame index -> [H//4, W//4] u8.
        Frame 0 of a HDR_F_DELTA_IS_FRAME0 file has no preview stream: its
        preview is made from the delta high plane."""
        bi, j = self._frame_to_batch[index]
        if bi == -1:
            with self._on_stream():
                return generate_preview(
                    self._delta_high[None])[0].cpu().numpy()
        return self.decode_previews(bi)[j]

    def decode_previews(self, index: int) -> np.ndarray:
        """Decode batch ``index``'s previews -> [B, H//4, W//4] uint8,
        without touching its main planes."""
        pb = self._parse_batch(self._batches[index][0])
        st = pb.preview
        with self._on_stream():
            staged = plane_codec.stage_plane_ranges(
                [] if st is None
                else [("preview", st, 0, st.nframes * st.plane_size)],
                self._device)
            _h, _l, pv, coded, ok = _decode_staged(
                staged, ("preview",),
                upload(pb.frame_flags.astype(np.int32), self._device),
                _flag_hints(pb.frame_flags), len(pb.frame_flags),
                self.header.ysize, self.header.xsize, self._delta_high,
                self._delta_low)
            return self._download_checked(pv, coded, ok).numpy()


class FpvtStreamingReader:
    """Incremental FPVT decoder: feed bytes, get frames per completed batch.

    Consumes the header and delta section once, then decodes every complete
    batch section as it arrives; the footer (if ever seen) ends the stream,
    so a truncated file without footer streams fully."""

    def __init__(
        self, callback, want_previews: bool = False, batch_hook=None,
        device="cuda", device_frames: bool = False,
        upload_cache: dict | None = None, content_id=None,
        buffer: np.ndarray | None = None,
    ) -> None:
        """``callback(frames u16 [B, H, W], timestamps i64 [B])`` per batch;
        with ``want_previews`` it receives a third argument, the
        [B, H//4, W//4] u8 previews.

        ``batch_hook(finalize, timestamps)``: pipelining hook.  When set,
        each complete batch (and the synthesized frame 0) is issued inside
        :meth:`decode` and the hook receives its ``finalize() -> (frames,
        previews or None)`` instead of the callback firing; the owner
        finalizes, on another thread, so batch n's download overlaps batch
        n+1's upload and decode (FpvtReader._issue).

        ``device_frames``: frames and previews stay on the device
        (FpvtReader._issue).  ``upload_cache``: an
        optional dict staging batch uploads on the device (FpvtReader),
        shared with any reader given the same dict; a staged section skips
        the parse and the upload.

        ``content_id``: the caller's identity of this stream's bytes.
        With an upload cache, sections are then keyed by (content_id,
        absolute byte offset) instead of a hash of their bytes; the caller
        guarantees that one id names identical bytes (two different
        streams fed under one id decode the first one's staged batches).

        ``buffer``: a u8 numpy array to hold the bytes fed, such as a
        finished reader's :attr:`buffer` (its contents are overwritten), so
        that a server of stream after stream allocates its buffers once."""
        self._callback = callback
        self._want_previews = want_previews
        self._batch_hook = batch_hook
        self._device = resolve_device(device)
        self._device_frames = device_frames
        self._upload_cache = upload_cache
        self._content_id = content_id
        # the bytes fed and not yet dropped are buffer[:_end], doubled
        # when full and compacted in place; sections parse into read-only
        # views of it (fpvt.parse_batch_section), which die once _issue has
        # staged them, before any later feed overwrites their bytes
        self.buffer = np.empty(0, np.uint8) if buffer is None else buffer
        self._end = 0
        self._inner: FpvtReader | None = None
        self._pos = 0
        self._abs_base = 0  # stream offset of buffer position 0
        self.complete = False  # the footer (index section) has arrived

    def _deliver(self, fin) -> None:
        if self._batch_hook is not None:
            self._batch_hook(fin, fin.timestamps)
            return
        imgs, pv = fin()
        if self._want_previews:
            self._callback(imgs, fin.timestamps, pv)
        else:
            self._callback(imgs, fin.timestamps)

    def decode(self, data: bytes) -> None:
        data = np.frombuffer(data, np.uint8)
        end = self._end + len(data)
        if end > len(self.buffer):
            grown = np.empty(max(end, 2 * len(self.buffer)), np.uint8)
            grown[: self._end] = self.buffer[: self._end]
            self.buffer = grown
        self.buffer[self._end : end] = data
        self._end = end
        buf = memoryview(self.buffer)[:end].toreadonly()
        if self._inner is None:
            if len(buf) < fpvt.HEADER_SIZE + 9:
                return
            (dsize,) = struct.unpack_from("<Q", buf, fpvt.HEADER_SIZE)
            if len(buf) < fpvt.HEADER_SIZE + dsize:
                return
            inner = FpvtReader.__new__(FpvtReader)
            inner._open(buf[: fpvt.HEADER_SIZE + dsize], self._device,
                        self._upload_cache)
            self._inner = inner
            self._pos = fpvt.HEADER_SIZE + dsize
            if inner.header.delta_is_frame0:
                self._deliver(inner._frame0_issue(self._want_previews,
                                                  self._device_frames))
        hdr = self._inner.header
        while len(buf) - self._pos >= 9:
            size, stype = struct.unpack_from("<QB", buf, self._pos)
            if stype == fpvt.SECTION_INDEX:
                self.complete = True
                break  # footer: end of frames
            if len(buf) - self._pos < size:
                break  # incomplete section
            key = None  # default: a hash of the section's bytes
            if self._upload_cache is not None and self._content_id is not None:
                key = ("cid", self._content_id, self._abs_base + self._pos,
                       hdr.ysize, hdr.xsize, hdr.chunk_log2)
            # parsed into views of the buffer, staged before _issue returns
            self._deliver(self._inner._issue(
                (buf, self._pos), self._want_previews, self._device_frames,
                key))
            self._pos += size
        # drop consumed bytes on every exit path, or a long stream's buffer
        # would keep everything decoded so far
        if self._pos > 1 << 22:
            self._abs_base += self._pos
            self._end -= self._pos
            self.buffer[: self._end] = self.buffer[self._pos : end]
            self._pos = 0

    def pending_bytes(self) -> int:
        """Bytes fed that no decoded section holds: an incomplete header or
        section, or the footer once it arrived (:attr:`complete`)."""
        return self._end - self._pos


def file_encode_setup(
    frames: np.ndarray,
    shift: int,
    big_endian: bool,
    frames_per_batch: int,
    chunk_log2: int,
    delta_frame: np.ndarray | None,
    timestamps: np.ndarray | None,
    device="cuda",
):
    """The preamble of a file-level encode: coerce and validate the inputs,
    split off the delta frame (without ``delta_frame``, frame 0 is stored
    once as the delta section, HDR_F_DELTA_IS_FRAME0, and its timestamp is
    dropped with it), and make the writer -> ``(writer, header bytes,
    body frames, body timestamps)``.  uint8 frames ride the shift-8
    little-endian layout (shift 0 promotes to 8).  The narrow-stream
    policy is decided from the total body size: the stored chunk states it
    saves only matter when the file is small."""
    frames = np.asarray(frames)
    shift = resolve_u8_shift(frames.dtype, shift, big_endian)
    if frames.dtype != np.uint8:
        frames = frames.astype(np.uint16, copy=False)
    n, h, w = frames.shape
    if timestamps is not None:
        timestamps = np.asarray(timestamps, dtype=np.int64)
        if timestamps.shape != (n,):
            raise ValueError("timestamps must have one entry per frame")
    delta_is_frame0 = delta_frame is None
    if delta_is_frame0:
        delta_frame, body = frames[0], frames[1:]
        ts_body = None if timestamps is None else timestamps[1:]
    else:
        body, ts_body = frames, timestamps
    wri = FpvtWriter(
        w, h, shift, big_endian, frames_per_batch, chunk_log2, device=device,
        delta_is_frame0=delta_is_frame0,
        narrow=body.size <= plane_codec.NARROW_MAX_SYMS,
    )
    return wri, wri.init(delta_frame), body, ts_body


def encode_file_fpvt(
    frames: np.ndarray,
    shift: int = 0,
    big_endian: bool = False,
    frames_per_batch: int = 16,
    chunk_log2: int = 12,
    delta_frame: np.ndarray | None = None,
    timestamps: np.ndarray | None = None,
    device="cuda",
) -> bytes:
    """One-shot FPVT encode of [N, H, W] uint16 (or uint8) frames
    (:func:`file_encode_setup`, then batches of ``frames_per_batch``).
    ``timestamps``: optional per-frame i64 array; without ``delta_frame``
    the synthesized frame 0 reports -1."""
    wri, header, body, ts_body = file_encode_setup(
        frames, shift, big_endian, frames_per_batch, chunk_log2, delta_frame,
        timestamps, device,
    )
    parts = [header]
    for s in range(0, body.shape[0], frames_per_batch):
        parts.append(wri.encode_batch(
            body[s : s + frames_per_batch],
            None if ts_body is None else ts_body[s : s + frames_per_batch],
        ))
    parts.append(wri.finish())
    with annotate("fpvt.write.join"):
        return b"".join(parts)


# decode_file_fpvt's output is page-locked up to this many bytes and
# pageable above: 1 GiB holds a 512-frame 1024 x 1024 recording, and a
# longer one is not locked whole
PINNED_OUTPUT_MAX_BYTES = 1 << 30
# files decode_file_fpvt decoded, by where their output lives
DECODE_FILE_OUTPUTS = {"pinned": 0, "pageable": 0}


def decode_file_fpvt(data: bytes, dtype=np.uint16, device="cuda") -> np.ndarray:
    """One-shot FPVT decode -> [N, H, W] uint16 (left-aligned values).

    The output is allocated once, from the header and the frame index, and
    each batch downloads straight into its slice of it; batch n+1 is
    issued before batch n is finalized, so on a card batch n's download
    overlaps batch n+1's decode.  On a card the returned array lives in
    page-locked memory from torch's caching host allocator while the
    file's decoded size is at most PINNED_OUTPUT_MAX_BYTES (the block goes
    back to the cache once the array is freed), and in pageable memory
    above that or on the CPU.  ``dtype=np.uint8`` returns the original
    8-bit samples of a file written from uint8 frames; the header's shift
    must say so."""
    r = FpvtReader(data, device=device)
    as_u8 = np.dtype(dtype) == np.uint8
    if as_u8:
        validate_u8_config(r.header.shift, r.header.big_endian)
    h, w = r.header.ysize, r.header.xsize
    n = r.numframes
    pinned = (r._device.type == "cuda"
              and 0 < n * h * w * 2 <= PINNED_OUTPUT_MAX_BYTES)
    out = torch.empty((n, h, w), dtype=torch.int16, pin_memory=pinned)
    start = 1 if r.header.delta_is_frame0 else 0
    pending = []
    for i, (_off, b) in enumerate(r._batches):
        pending.append((r._issue(i), out[start : start + b]))
        start += b
        if len(pending) == 2:
            fin, dst = pending.pop(0)
            fin(dst)
    for fin, dst in pending:
        fin(dst)
    with annotate("fpvt.read.assemble"):
        if r.header.delta_is_frame0:
            r._frame0_into(out[:1])
        DECODE_FILE_OUTPUTS["pinned" if pinned else "pageable"] += 1
        frames = out.numpy().view(np.uint16)
        if as_u8:
            return (frames >> 8).astype(np.uint8)
        return frames.astype(dtype, copy=False)


def _warmup_frames(rng, n: int, ysize: int, xsize: int, shift: int):
    """Synthetic warmup batch: iid noise plus a strong per-frame brightness
    drift, so non-anchor frames' prev-frame residual (one drift step) beats
    both the static delta and no prediction, as in temporally correlated
    streams.  Noise keeps every residual plane non-constant, so every
    kernel runs."""
    # int64 arithmetic: maxv = 65536 at shift=0 overflows uint16 scalars,
    # and tiny sample ranges (shift >= 11) need the floors
    maxv = 1 << (16 - shift)
    noise = rng.integers(0, max(maxv // 64, 1), (n, ysize, xsize), np.int64)
    drift = (np.arange(n, dtype=np.int64) * max(maxv // 16, 1)) % maxv
    return ((noise + drift[:, None, None]) % maxv).astype(np.uint16)


def warmup_stream(
    xsize: int,
    ysize: int,
    shift: int = 0,
    big_endian: bool = False,
    frames_per_batch: int = 16,
    chunk_log2: int = 12,
    device="cuda",
    decode: bool = True,
    previews: bool = False,
    mesh=None,
) -> None:
    """Pay a stream geometry's one-time costs before traffic arrives: on a
    card, the kernels' nvcc build and load (``utils.kernels.library``) and
    the CUDA context, then one batch encoded as the hubs encode it
    (``narrow=False``) and, with ``decode``, decoded (with its previews
    when ``previews``).  Synthetic drifting-noise frames
    (:func:`_warmup_frames`) make every kernel run.

    ``mesh`` (a :class:`fpv_tpu_torch.parallel.mesh.Mesh`): also run one
    mesh group of such frames (a batch per data shard) through
    ``sharded_encode_file`` and, with ``decode``, ``sharded_decode_file``
    (with previews when ``previews``), which warms every shard's device;
    anything but a ``Mesh`` raises ValueError."""
    if mesh is not None:
        from fpv_tpu_torch.parallel import mesh as pmesh

        if not isinstance(mesh, pmesh.Mesh):
            raise ValueError("mesh= takes a Mesh of fpv_tpu_torch/parallel/"
                             "mesh.py (make_mesh)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        kernels.library()
    rng = np.random.default_rng(0)
    frames = _warmup_frames(rng, frames_per_batch + 1, ysize, xsize, shift)
    wri = FpvtWriter(
        xsize, ysize, shift, big_endian, frames_per_batch, chunk_log2,
        device=dev, narrow=False,
    )
    data = b"".join([wri.init(frames[0]), wri.encode_batch(frames[1:]),
                     wri.finish()])
    if decode:
        rdr = FpvtReader(data, device=dev)
        if previews:
            rdr.decode_batch_with_previews(0)
        else:
            rdr.decode_batch(0)
    if mesh is not None:
        n = mesh.shape["data"] * frames_per_batch
        mframes = _warmup_frames(rng, n + 1, ysize, xsize, shift)
        mdata = pmesh.sharded_encode_file(
            mframes, mesh, shift=shift, big_endian=big_endian,
            frames_per_batch=frames_per_batch, chunk_log2=chunk_log2,
        )
        if decode:
            pmesh.sharded_decode_file(mdata, mesh, want_previews=previews)

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
byte-identical to the JAX package's device (pallas-engine) writer with the
narrow-stream policy off; all streams use the 1024-lane geometry.
"""

from __future__ import annotations

import numpy as np
import torch

from fpv_tpu_torch.entropy.plane_codec import (
    PlaneStream,
    _hist_flat,
    _to_block_symbols,
    code_blocks,
    const_plane_stream,
    ctx_combine_device,
    ctx_presence_device,
    decode_plane_batch,
    encode_plane_batch,
    lens_tensor,
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
from fpv_tpu_torch.ops.planes import combine_planes, split_planes, to_int16
from fpv_tpu_torch.ops.predict import (
    cg2d_decode,
    cg2d_encode,
    clamped_gradient,
    up_decode,
    up_encode,
)
from fpv_tpu_torch.ops.preview import generate_preview
from fpv_tpu_torch.ops.rans_layout import CODING_CTX16, CODING_ORDER0, CTX_NIDX

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


def _cost(x: torch.Tensor) -> torch.Tensor:
    """Per-frame sum of wraparound magnitudes of mod-256 residuals, summed
    exactly in int64 and cast to float32 (the JAX package sums in float32,
    which is exact while partial sums stay below 2^24)."""
    xi = x.to(torch.int32).reshape(x.shape[0], -1)
    mag = torch.minimum(xi, 256 - xi)
    return mag.sum(dim=1, dtype=torch.int64).to(torch.float32)


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
    v = plane.reshape(-1).to(torch.int32)
    sym = torch.arange(256, dtype=torch.int32, device=plane.device)
    m_plain = (sym >= v.min()) & (sym <= v.max())
    r = (v + 128) & 255
    rsym = (sym + 128) & 255
    m_rec = (rsym >= r.min()) & (rsym <= r.max())
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
    # preview, which both sides can compute
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


def _encode_plane_fused(
    plane: torch.Tensor, k: int, hist, mask, ctx: bool
) -> PlaneStream:
    """One residual plane batch [B, S] -> PlaneStream with device tables:
    the CODING_CONST short-circuit, then K1 and the CODING_RAW policy."""
    b, s = plane.shape
    vmin, vmax = (int(v) for v in torch.aminmax(plane))
    if vmin == vmax:
        return const_plane_stream(b, s, k, vmin)
    lens = lens_tensor(b, s, k, plane.device)
    nblocks = lens.shape[0]
    if ctx:
        # ctx*16+sym is computed inside K1 from the previous step's
        # symbols; the table histogram samples the step axis
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
    return code_blocks(plane, syms, lens, fc, freq.cpu().numpy(),
                       CODING_CTX16 if ctx else CODING_ORDER0)


def fused_encode_batch(
    imgs: torch.Tensor,
    delta_high: torch.Tensor,
    delta_low: torch.Tensor,
    shift: int,
    big_endian: bool,
    chunk_len: int,
    low_coding: int = CODING_ORDER0,
):
    """Whole-batch FPVT encode -> (frame flags u8 [B], (high, low, preview)
    PlaneStreams), with static-delta and prev-frame temporal candidates.
    Tables are normalized on the device; only tables, states, counts and
    the tight payloads come to the host."""
    low_ctx = low_coding == CODING_CTX16
    m = encode_model_step(
        imgs, delta_high, delta_low, shift, big_endian, True, low_ctx, True,
    )
    b = imgs.shape[0]
    streams = tuple(
        _encode_plane_fused(
            m[name].reshape(b, -1),
            pv_chunk_len(chunk_len) if name == "preview" else chunk_len,
            m[f"hist_{name}"], m[f"mask_{name}"],
            ctx=name == "low" and low_ctx,
        )
        for name in ("high", "low", "preview")
    )
    return _pack_flags(m), streams


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
    ) -> None:
        """The delta frame given to :meth:`init` is frame 0 of the file
        (HDR_F_DELTA_IS_FRAME0).  Batches may use prev-frame prediction
        (F_USE_PREV, anchored every PREV_ANCHOR frames), as the JAX
        writer's default does."""
        if xsize < 4 or ysize < 4:
            raise NotImplementedError(
                "frames smaller than 4x4 (no preview stream) are not "
                "supported by fpv_tpu_torch yet"
            )
        if not 4 <= chunk_log2 <= 16:
            raise ValueError("chunk_log2 must be in [4, 16]")
        self._device = torch.device(device)
        self.header = Header(
            xsize=xsize,
            ysize=ysize,
            shift=shift,
            big_endian=big_endian,
            chunk_log2=chunk_log2,
            frames_per_batch=frames_per_batch,
            delta_is_frame0=True,
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
        """u16 frames -> int32 tensor on the writer's device (uploaded as
        16-bit words, widened there)."""
        arr = np.ascontiguousarray(frames, dtype=np.uint16).view(np.int16)
        return torch.from_numpy(arr).to(self._device).to(torch.int32) & 0xFFFF

    def init(self, delta_frame: np.ndarray) -> bytes:
        """Header + delta section bytes; keeps the delta planes on device.

        The delta section's high plane takes the spatial predictor with the
        least exact Shannon entropy (one frame, host-side decision), and
        both planes are coded with host-normalized tables."""
        img = self._put(
            np.asarray(delta_frame).reshape(
                1, self.header.ysize, self.header.xsize
            )
        )
        high, low, nonzero_low = split_planes(
            img, self.header.shift, self.header.big_endian
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
        hs = encode_plane_batch(
            hres.reshape(1, -1),
            _batch_hist(hres).cpu().numpy(),
            self._chunk_len,
            mask=_support_mask(hres).cpu().numpy(),
        )
        ls = None
        if has_low:
            order0 = self._low_coding == CODING_ORDER0
            ls = encode_plane_batch(
                low.reshape(1, -1),
                _batch_hist(low).cpu().numpy() if order0 else None,
                self._chunk_len,
                coding=self._low_coding,
                mask=_support_mask(low).cpu().numpy() if order0 else None,
            )
        dflags = (0 if has_low else F_NO_LOW) | (spatial << F_SPATIAL_SHIFT)
        out = self.header.serialize() + fpvt.serialize_delta_section(
            dflags, hs, ls
        )
        self._bytes_written = len(out)
        return out

    def encode_batch(self, imgs: np.ndarray) -> bytes:
        """Encode [B, H, W] uint16 frames -> the next batch section."""
        if self._delta_high is None:
            raise RuntimeError("init() must be called first")
        flags, (hs, ls, pvs) = fused_encode_batch(
            self._put(imgs),
            self._delta_high,
            self._delta_low,
            self.header.shift,
            self.header.big_endian,
            self._chunk_len,
            low_coding=self._low_coding,
        )
        timestamps = np.full(len(flags), -1, dtype=np.int64)
        section = fpvt.serialize_batch_section(flags, timestamps, hs, ls, pvs)
        self._batch_offsets.append((self._bytes_written, len(flags)))
        self._bytes_written += len(section)
        self._total_frames += len(flags)
        return section

    def finish(self) -> bytes:
        return fpvt.serialize_footer(self._batch_offsets, self._total_frames)


# ---------------------------------------------------------------------------
# decode


def _inverse_spatial(res: torch.Tensor, spatial: np.ndarray) -> torch.Tensor:
    """Invert each frame's spatial predictor ([B] host flags 0/1/2): 'up'
    frames by prefix sum, CG2D frames by the wavefront (K3)."""
    out = res
    for mode, inverse in ((SPATIAL_UP, up_decode), (SPATIAL_CG2D, cg2d_decode)):
        sel = np.flatnonzero(spatial == mode)
        if sel.size:
            if out is res:
                out = res.clone()
            idx = torch.from_numpy(sel).to(res.device)
            out[idx] = inverse(res[idx])
    return out


def _decode_delta_planes(dflags, dh_stream, dl_stream, h, w, device):
    """Decode the delta-section planes, inverting the high plane's spatial
    prediction recorded in dflags bits 1-2 (see FpvtWriter.init)."""
    dh = decode_plane_batch(dh_stream, device, "delta-section high")
    dh = dh.reshape(1, h, w)
    dh = _inverse_spatial(dh, np.array([(dflags >> F_SPATIAL_SHIFT) & 3]))
    if dl_stream is None:
        return dh[0], torch.zeros((h, w), dtype=torch.uint8, device=device)
    dl = decode_plane_batch(dl_stream, device, "delta-section low")
    return dh[0], dl.reshape(h, w)


def _apply_temporal(high, low, flags, delta_high, delta_low):
    """Invert the temporal prediction: static delta-add, or (F_USE_PREV) a
    mod-256 running sum over frames."""
    use_delta = (flags & F_USE_DELTA) != 0
    use_prev = (flags & F_USE_PREV) != 0
    if not use_prev.any():
        ud = torch.from_numpy(use_delta).to(high.device)
        return (
            _where3(ud, high + delta_high[None], high),
            _where3(ud, low + delta_low[None], low),
        )
    hs, ls = high.clone(), low.clone()
    # frame 0's "previous frame" is the delta section
    ph, pl = delta_high, delta_low
    for t in range(len(flags)):
        if use_prev[t]:
            hs[t] += ph
            ls[t] += pl
        elif use_delta[t]:
            hs[t] += delta_high
            ls[t] += delta_low
        ph, pl = hs[t], ls[t]
    return hs, ls


def _to_u16(high: torch.Tensor, low: torch.Tensor) -> np.ndarray:
    """(high, low) u8 planes -> host uint16 frames (downloaded as 16-bit
    words)."""
    return to_int16(combine_planes(high, low)).cpu().numpy().view(np.uint16)


def fused_decode_batch(
    pb: fpvt.ParsedBatch,
    delta_high: torch.Tensor,
    delta_low: torch.Tensor,
    h: int,
    w: int,
    device,
) -> np.ndarray:
    """Decode a parsed batch section -> [B, H, W] uint16 (left-aligned)."""
    b = len(pb.frame_flags)
    high = decode_plane_batch(pb.high, device, "high").reshape(b, h, w)
    if pb.low is not None:
        low = decode_plane_batch(pb.low, device, "low").reshape(b, h, w)
    else:
        low = torch.zeros((b, h, w), dtype=torch.uint8, device=device)
    flags = pb.frame_flags
    high = _inverse_spatial(high, (flags >> F_SPATIAL_SHIFT) & 3)
    high, low = _apply_temporal(high, low, flags, delta_high, delta_low)
    return _to_u16(high, low)


class FpvtReader:
    """FPVT reader: each batch section decodes on ``device``."""

    def __init__(self, data: bytes, device="cuda") -> None:
        self._device = torch.device(device)
        self._data = bytes(data)
        self.header = Header.parse(self._data)
        h, w = self.header.ysize, self.header.xsize
        dflags, dh_stream, dl_stream = fpvt.parse_delta_section(
            self._data, fpvt.HEADER_SIZE, plane_size=h * w
        )
        self._delta_high, self._delta_low = _decode_delta_planes(
            dflags, dh_stream, dl_stream, h, w, self._device
        )
        self._batches = fpvt.parse_footer(self._data)

    def frame0(self) -> np.ndarray:
        """The delta frame, which is frame 0 when the header declares
        HDR_F_DELTA_IS_FRAME0 (left-aligned u16, like decode_batch)."""
        return _to_u16(self._delta_high[None], self._delta_low[None])[0]

    @property
    def num_batches(self) -> int:
        return len(self._batches)

    def decode_batch(self, index: int) -> np.ndarray:
        """Decode batch ``index`` -> [B, H, W] uint16 (left-aligned values)."""
        off, _b = self._batches[index]
        h, w = self.header.ysize, self.header.xsize
        pb = fpvt.parse_batch_section(
            self._data, off, plane_size=h * w,
            preview_size=(h // 4) * (w // 4),
        )
        return fused_decode_batch(
            pb, self._delta_high, self._delta_low, h, w, self._device
        )


def encode_file_fpvt(
    frames: np.ndarray,
    shift: int = 0,
    big_endian: bool = False,
    frames_per_batch: int = 16,
    chunk_log2: int = 12,
    device="cuda",
) -> bytes:
    """One-shot FPVT encode of [N, H, W] uint16 frames.

    Frame 0 is stored once as the delta section (HDR_F_DELTA_IS_FRAME0)
    and the rest are coded in batches of ``frames_per_batch``.  Every batch
    timestamp is -1."""
    frames = np.asarray(frames)
    if frames.dtype == np.uint8:
        raise NotImplementedError(
            "uint8 input is not supported by fpv_tpu_torch yet"
        )
    frames = frames.astype(np.uint16, copy=False)
    n, h, w = frames.shape
    wri = FpvtWriter(
        w, h, shift, big_endian, frames_per_batch, chunk_log2, device=device
    )
    parts = [wri.init(frames[0])]
    for s in range(1, n, frames_per_batch):
        parts.append(wri.encode_batch(frames[s : s + frames_per_batch]))
    parts.append(wri.finish())
    return b"".join(parts)


def decode_file_fpvt(data: bytes, device="cuda") -> np.ndarray:
    """One-shot FPVT decode -> [N, H, W] uint16 (left-aligned values)."""
    r = FpvtReader(data, device=device)
    outs = [r.decode_batch(i) for i in range(r.num_batches)]
    if r.header.delta_is_frame0:
        outs.insert(0, r.frame0()[None])
    h, w = r.header.ysize, r.header.xsize
    return np.concatenate(outs) if outs else np.zeros((0, h, w), np.uint16)

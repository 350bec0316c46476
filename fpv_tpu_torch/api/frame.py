"""Frame model of the FPV1 profile, batched on the device.

The reference models a frame as a mutable state machine (``class Frame``,
fusion_power_video.h:75-139).  Here a batch of frames is a
:class:`FramePlanes` of [B, H, W] uint8 tensors on one device plus host
flags, and each stage is a function of the whole batch.  A missing low
plane is carried as zeros with ``NO_LOW_BYTES`` set: it is never
serialized, and subtracting or adding a zero plane is the identity, so
every batch takes one path whatever planes its frames have.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from fpv_tpu_torch.models import heuristics, predictors
from fpv_tpu_torch.ops import planes as plane_ops
from fpv_tpu_torch.ops.preview import generate_preview

__all__ = ["ChunkFlags", "FrameFlags", "FramePlanes", "adopt_planes",
           "combine_planes", "combine_planes_delta", "generate_preview",
           "predict", "split_planes", "unextract_frame", "unpredict"]


class FrameFlags(enum.IntFlag):
    """Per-image bitstream flags (fusion_power_video.h:68-73)."""

    NONE = 0
    USE_DELTA = 1
    USE_CG = 2
    NO_LOW_BYTES = 4


class ChunkFlags(enum.IntEnum):
    """Container chunk type flags (fusion_power_video.cc:104-109)."""

    FRAME = 0
    DELTA_FRAME = 1
    FRAME_INDEX = 2


@dataclasses.dataclass
class FramePlanes:
    """Byte planes of a batch of frames on one device.

    ``high`` and ``low`` are [B, H, W] uint8 (``low`` all zero where a
    frame has none), ``preview`` [B, H//4, W//4] uint8 or None, ``flags``
    one int of :class:`FrameFlags` per frame."""

    high: torch.Tensor
    low: torch.Tensor
    preview: torch.Tensor | None = None
    flags: list[int] = dataclasses.field(default_factory=list)

    @property
    def xsize(self) -> int:
        return self.high.shape[-1]

    @property
    def ysize(self) -> int:
        return self.high.shape[-2]


def _no_low_flags(nonzero_low) -> list[int]:
    return [0 if nz else int(FrameFlags.NO_LOW_BYTES) for nz in nonzero_low]


def split_planes(imgs: torch.Tensor, shift: int = 0,
                 big_endian: bool = False) -> FramePlanes:
    """[B, H, W] u16 samples (int32, or uint8 for 8-bit input) -> byte
    planes, replicating Frame's import ctor (fusion_power_video.cc:370-465)
    with NO_LOW_BYTES where the low plane is absent or all zero (:447-449)."""
    high, low, nonzero_low = plane_ops.split_planes(imgs, shift, big_endian)
    return FramePlanes(high=high, low=low,
                       flags=_no_low_flags(nonzero_low.tolist()))


def adopt_planes(high: torch.Tensor,
                 low: torch.Tensor | None = None) -> FramePlanes:
    """Pre-split [B, H, W] uint8 byte planes enter as they are (the
    reference's plane-adopting ctor, fusion_power_video.cc:467-489);
    NO_LOW_BYTES where ``low`` is None or a frame's low plane is all zero,
    as the image ctor decides it."""
    if high.dtype != torch.uint8 or high.dim() != 3:
        raise ValueError("high planes must be [B, H, W] uint8")
    if low is None:
        return FramePlanes(high=high, low=torch.zeros_like(high),
                           flags=_no_low_flags([False] * high.shape[0]))
    if low.shape != high.shape or low.dtype != torch.uint8:
        raise ValueError("low plane shape must match high plane")
    return FramePlanes(high=high, low=low,
                       flags=_no_low_flags((low != 0).flatten(1).any(1)
                                           .tolist()))


def _where(mask: list[bool], a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per frame of a [B, ...] batch: ``a`` where ``mask``, else ``b``."""
    m = torch.tensor(mask, dtype=torch.bool, device=a.device)
    return torch.where(m.reshape(-1, *([1] * (a.dim() - 1))), a, b)


def predict(planes: FramePlanes, delta: FramePlanes | None,
            make_preview: bool = True) -> FramePlanes:
    """Preview + optional delta + optional CG for a batch (Frame::Predict,
    fusion_power_video.cc:777-785).  The preview comes from the unpredicted
    high plane; delta prediction is decided on that plane and taken only
    with a delta frame; CG is decided on the (delta-predicted) high plane
    and, when taken, also codes the preview at its real extent
    (fusion_power_video.cc:575-586 reads past it, which is not copied).
    One download of the decision histograms per batch."""
    high, low = planes.high, planes.low
    preview = generate_preview(high) if make_preview else None
    coded = None
    if delta is not None:
        coded = predictors.delta_encode(high, delta.high)
    counts = heuristics.decision_counts(high, coded).cpu().numpy()
    use_delta, use_cg = heuristics.decide(counts, delta is not None)
    if any(use_delta):
        high = _where(use_delta, coded, high)
        low = _where(use_delta, predictors.delta_encode(low, delta.low), low)
    if any(use_cg):
        high = _where(use_cg, predictors.cg_flat_encode(high), high)
        if preview is not None and preview.numel():
            preview = _where(use_cg, predictors.cg_flat_encode(preview),
                             preview)
    flags = [f | (FrameFlags.USE_DELTA if d else 0)
             | (FrameFlags.USE_CG if c else 0)
             for f, d, c in zip(planes.flags, use_delta, use_cg)]
    return FramePlanes(high=high, low=low, preview=preview,
                       flags=[int(f) for f in flags])


def unpredict(planes: FramePlanes, delta: FramePlanes | None) -> FramePlanes:
    """Inverse of :func:`predict` for the main planes: the flat CG inverse
    of the USE_CG frames' high planes in one K4 launch, then the delta add
    of the USE_DELTA frames.  The planes may be taller than the image (a
    grown preview); the CG inverse of the leading rows does not depend on
    the rows after them."""
    high, low = planes.high, planes.low
    cg = [i for i, f in enumerate(planes.flags) if f & FrameFlags.USE_CG]
    if cg and len(cg) == len(planes.flags):
        high = predictors.cg_flat_decode(high)
    elif cg:
        idx = torch.tensor(cg, device=high.device)
        high = high.index_copy(0, idx, predictors.cg_flat_decode(high[idx]))
    use_delta = [bool(f & FrameFlags.USE_DELTA) for f in planes.flags]
    if any(use_delta):
        if delta is None:
            raise ValueError("delta frame required to unpredict")
        high = _where(use_delta, predictors.delta_decode(high, delta.high),
                      high)
        low = _where(use_delta, predictors.delta_decode(low, delta.low), low)
    return FramePlanes(high=high, low=low, preview=planes.preview,
                       flags=[f & FrameFlags.NO_LOW_BYTES
                              for f in planes.flags])


def combine_planes(high: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """(high, low) byte planes -> int32 u16 samples
    (fusion_power_video.cc:341-343)."""
    return plane_ops.combine_planes(high, low)


def combine_planes_delta(high: torch.Tensor, low: torch.Tensor,
                         delta_high: torch.Tensor,
                         delta_low: torch.Tensor) -> torch.Tensor:
    """Delta-add + combine, DecompressImage's fused loop
    (fusion_power_video.cc:335-339)."""
    return plane_ops.combine_planes_delta(high, low, delta_high, delta_low)


def unextract_frame(img, shift: int, big_endian: bool) -> np.ndarray:
    """One u16 frame (array or tensor) -> the original raw bytes
    (fusion_power_video.cc:850-862)."""
    t = torch.as_tensor(np.asarray(img, dtype=np.uint16).astype(np.int32))
    words = plane_ops.unextract(t, shift, big_endian).numpy()
    return words.astype("<u2").view(np.uint8).reshape(-1)

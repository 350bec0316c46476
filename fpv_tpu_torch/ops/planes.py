"""Batched byte-plane ops: split / combine.

PyTorch versions of the reference's frame import/export inner loops
(fusion_power_video.cc:370-489) on ``[B, H, W]`` batches.  Samples travel
as int32 tensors holding u16 values (torch's uint16 support is limited);
planes are uint8, whose add/sub wrap mod 256 as the format needs.
"""

from __future__ import annotations

import numpy as np
import torch


def validate_shift(shift: int, big_endian: bool) -> None:
    """Reject shift configurations no split implementation defines
    (big-endian shifts above 8 drive the reference's rotate path into a
    negative shift count)."""
    if not 0 <= shift <= 16:
        raise ValueError(f"shift must be in [0, 16], got {shift}")
    if big_endian and shift > 8:
        raise ValueError(
            "big-endian shifts above 8 are not supported (the reference's "
            "rotate path shifts by a negative amount there)"
        )


def validate_u8_config(shift: int, big_endian: bool) -> None:
    """8-bit direct input is only decodable under shift=8 little-endian:
    the container records no bit depth, so a uint8 frame rides the
    shift==8 single-plane layout (Frame's uint8 ctor,
    fusion_power_video.cc:453-465)."""
    if shift != 8 or big_endian:
        raise ValueError(
            "uint8 frames require a shift=8 little-endian stream "
            f"(got shift={shift}, big_endian={big_endian}); widen to "
            "uint16 yourself for other configurations"
        )


def resolve_u8_shift(dtype, shift: int, big_endian: bool) -> int:
    """The effective shift of a file-level encode: uint8 input promotes
    shift 0 (the default) to 8; an explicit shift must already be 8."""
    if np.dtype(dtype) != np.uint8:
        return shift
    if shift == 0:
        shift = 8
    validate_u8_config(shift, big_endian)
    return shift


def split_planes(img: torch.Tensor, shift: int = 0, big_endian: bool = False):
    """int32 [B, H, W] u16 samples -> (high u8, low u8, nonzero_low bool[B]).

    Replicates the import paths of Frame's ctor exactly, including the
    rotate-based combined endian-swap + shift formula
    (fusion_power_video.cc:405-417).  For ``shift==8`` the low plane is
    all-zero and callers treat it as absent.  uint8 input is Frame's 8-bit
    ctor (fusion_power_video.cc:453-465): the samples are the high plane
    and there is no low plane, as the uint16 shift-8 split of the widened
    samples gives.
    """
    validate_shift(shift, big_endian)
    if img.dtype == torch.uint8:
        nonzero_low = torch.zeros(img.shape[0], dtype=torch.bool,
                                  device=img.device)
        return img, torch.zeros_like(img), nonzero_low
    img = img.to(torch.int32) & 0xFFFF
    if big_endian:
        if shift == 0:
            high, low = img & 0xFF, img >> 8
        elif shift == 8:
            high, low = img >> 8, torch.zeros_like(img)
        else:
            high = (img << shift) | (img >> (16 - shift))
            low = img >> (8 - shift)
    else:
        if shift == 8:
            high, low = img, torch.zeros_like(img)
        else:
            # shift == 16 moves every bit out of the u16 word
            shifted = (img << shift) & 0xFFFF
            high, low = shifted >> 8, shifted
    high = (high & 0xFF).to(torch.uint8)
    low = (low & 0xFF).to(torch.uint8)
    if shift == 8:
        nonzero_low = torch.zeros(img.shape[0], dtype=torch.bool,
                                  device=img.device)
    else:
        nonzero_low = (low != 0).flatten(1).any(dim=1)
    return high, low, nonzero_low


def combine_planes(high: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """(high, low) u8 planes -> int32 u16 samples
    (fusion_power_video.cc:341-343)."""
    return (high.to(torch.int32) << 8) | low.to(torch.int32)


def combine_planes_delta(high: torch.Tensor, low: torch.Tensor,
                         delta_high: torch.Tensor,
                         delta_low: torch.Tensor) -> torch.Tensor:
    """Delta-add + combine (fusion_power_video.cc:335-339): each plane
    plus the delta frame's, mod 256, then combined to int32 u16 samples."""
    return combine_planes(high + delta_high, low + delta_low)


def unextract(img: torch.Tensor, shift: int = 0,
              big_endian: bool = False) -> torch.Tensor:
    """u16 samples (any integer dtype) -> the raw u16 words the camera
    emitted, as int32: shift right, then swap the bytes of a big-endian
    stream (fusion_power_video.cc:850-862)."""
    u = (img.to(torch.int32) & 0xFFFF) >> shift
    if big_endian:
        u = ((u << 8) | (u >> 8)) & 0xFFFF
    return u


def to_int16(v: torch.Tensor) -> torch.Tensor:
    """Values in [0, 65536) -> int16 with the same 16 bits (the dtype that
    carries u16 words to and from numpy ``uint16`` views)."""
    return torch.where(v >= 32768, v - 65536, v).to(torch.int16)

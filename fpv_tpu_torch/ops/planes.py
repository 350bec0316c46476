"""Batched byte-plane ops: split / combine.

PyTorch versions of the reference's frame import/export inner loops
(fusion_power_video.cc:370-489) on ``[B, H, W]`` batches.  Samples travel
as int32 tensors holding u16 values (torch's uint16 support is limited);
planes are uint8, whose add/sub wrap mod 256 as the format needs.
"""

from __future__ import annotations

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


def split_planes(img: torch.Tensor, shift: int = 0, big_endian: bool = False):
    """int32 [B, H, W] u16 samples -> (high u8, low u8, nonzero_low bool[B]).

    Replicates the import paths of Frame's ctor exactly, including the
    rotate-based combined endian-swap + shift formula
    (fusion_power_video.cc:405-417).  For ``shift==8`` the low plane is
    all-zero and callers treat it as absent.
    """
    validate_shift(shift, big_endian)
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


def to_int16(v: torch.Tensor) -> torch.Tensor:
    """Values in [0, 65536) -> int16 with the same 16 bits (the dtype that
    carries u16 words to and from numpy ``uint16`` views)."""
    return torch.where(v >= 32768, v - 65536, v).to(torch.int16)

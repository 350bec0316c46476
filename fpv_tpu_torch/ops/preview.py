"""Batched preview generation (fusion_power_video.cc:491-515)."""

from __future__ import annotations

import torch


def generate_preview(high: torch.Tensor) -> torch.Tensor:
    """[B, H, W] uint8 high planes -> [B, H//4, W//4] uint8 previews.

    4x4 box filter over the high plane, ``(sum / 16) & 0xfe`` (LSB cleared).
    Only complete 4x4 blocks contribute (floor semantics).
    """
    b, h, w = high.shape
    ph, pw = h // 4, w // 4
    blocks = high[:, : ph * 4, : pw * 4].to(torch.int32)
    sums = blocks.reshape(b, ph, 4, pw, 4).sum(dim=(2, 4))
    return ((sums // 16) & 0xFE).to(torch.uint8)

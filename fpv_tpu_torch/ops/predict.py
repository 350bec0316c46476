"""Batched spatial predictors on uint8 planes, and the CG2D inverse (K3).

Encode-side transforms read original neighbor values and are fully
parallel.  Decode-side: "up" is a mod-256 prefix sum down columns; the FPVT
2D clamped-gradient predictor (row 0 verbatim, column 0 north-predicted)
inverts with an anti-diagonal wavefront of depth H+W-1 — the hand-written
CUDA kernel ``csrc/cg2d_decode.cu`` (:func:`cg2d_decode`), whose plain
version is :func:`cg2d_decode_ref`.
"""

from __future__ import annotations

import torch

from fpv_tpu_torch.utils import kernels


def clamped_gradient(
    n: torch.Tensor, w: torch.Tensor, nw: torch.Tensor
) -> torch.Tensor:
    """Branchless ClampedGradient on uint8 (fusion_power_video.cc:247-252)."""
    i = torch.minimum(n, w)
    a = torch.maximum(n, w)
    g = n + w - nw  # uint8 wraparound
    clamped = torch.where(nw < i, a, g)
    return torch.where(nw > a, i, clamped)


def cg2d_encode(plane: torch.Tensor) -> torch.Tensor:
    """FPVT 2D CG residual of [B, H, W] u8: row 0 verbatim, column 0
    north-predicted, interior clamped-gradient."""
    n = torch.roll(plane, 1, dims=1)
    w = torch.roll(plane, 1, dims=2)
    nw = torch.roll(n, 1, dims=2)
    out = plane - clamped_gradient(n, w, nw)
    out[:, :, 0] = plane[:, :, 0] - n[:, :, 0]
    out[:, 0, :] = plane[:, 0, :]
    return out


def up_encode(plane: torch.Tensor) -> torch.Tensor:
    """North-prediction residual: row 0 verbatim, rows y: x[y]-x[y-1]."""
    out = plane - torch.roll(plane, 1, dims=1)
    out[:, 0, :] = plane[:, 0, :]
    return out


def up_decode(res: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`up_encode`: mod-256 cumulative sum down columns."""
    return (torch.cumsum(res, dim=1) & 0xFF).to(torch.uint8)


def cg2d_decode_ref(res: torch.Tensor, group_rows: int = 1024) -> torch.Tensor:
    """Plain PyTorch K3, on the kernel's schedule: row groups of
    ``group_rows`` rows in order; at step t of a group, row i computes
    pixel (i, t - i), one vector op over the group's rows for the whole
    batch.  w is the row's previous output, n the previous output of the
    row above (the group's first row reads the row above the group from
    the output), nw the previous step's n."""
    b, h, w = res.shape
    out = torch.empty_like(res)
    for y0 in range(0, h, group_rows):
        rows = min(group_rows, h - y0)
        i = torch.arange(rows, device=res.device)
        r = res[:, y0 : y0 + rows]
        north = out[:, y0 - 1] if y0 else torch.zeros_like(res[:, 0])
        top = (i == 0) & (y0 == 0)  # row 0: n = 0, stored verbatim
        wv = torch.zeros_like(r[:, :, 0])
        nw = wv
        for t in range(rows + w - 1):
            x = t - i
            xc = x.clamp(0, w - 1)
            n = torch.cat([north[:, xc[:1]], wv[:, :-1]], dim=1)
            pred = torch.where((x == 0) | top, n, clamped_gradient(n, wv, nw))
            wv = r[:, i, xc] + pred
            nw = n
            on = (x >= 0) & (x < w)
            out[:, y0 + i[on], x[on]] = wv[:, on]
    return out


def cg2d_decode(res: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`cg2d_encode` on [B, H, W] u8: K3 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if res.device.type == "cpu":
        return cg2d_decode_ref(res)
    res = res.contiguous()
    kernels.check_cuda(res, torch.uint8, "res")
    b, h, w = res.shape
    out = torch.empty_like(res)
    kernels.launch("cg2d_decode", "fpvt_cg2d_decode", res.device,
                   res.data_ptr(), out.data_ptr(), b, h, w)
    return out

"""Prediction models of the FPV1 profile on [B, H, W] uint8 planes.

* byte-plane **delta** prediction against one static delta frame
  (fusion_power_video.cc:517-544): subtraction mod 256;
* **flat clamped-gradient** (CG) prediction of the high plane
  (fusion_power_video.cc:546-593): the plane is a FLAT buffer, so pixel
  ``i`` is predicted from ``n = flat[i-W]``, ``w = flat[i-1]`` and
  ``nw = flat[i-W-1]`` (a column-0 pixel's west neighbour is the previous
  row's last pixel), and pixels ``i <= W`` are stored verbatim.

The encode side reads original neighbours and is elementwise.  The
inverse is a scan with one dependency chain of H*W steps per plane; on a
CUDA tensor it runs in the hand-written kernel ``csrc/cg_flat_decode.cu``
(K4, :func:`cg_flat_decode`), whose plain version is
:func:`cg_flat_decode_ref`.
"""

from __future__ import annotations

import torch

from fpv_tpu_torch.ops.predict import clamped_gradient
from fpv_tpu_torch.utils import kernels

__all__ = ["clamped_gradient", "cg_flat_decode", "cg_flat_decode_ref",
           "cg_flat_encode", "delta_decode", "delta_encode"]


def delta_encode(plane: torch.Tensor, delta_plane: torch.Tensor) -> torch.Tensor:
    """plane - delta_plane mod 256 (fusion_power_video.cc:534-537)."""
    return plane - delta_plane


def delta_decode(plane: torch.Tensor, delta_plane: torch.Tensor) -> torch.Tensor:
    """plane + delta_plane mod 256 (fusion_power_video.cc:600-603)."""
    return plane + delta_plane


def cg_flat_encode(plane: torch.Tensor) -> torch.Tensor:
    """Flat CG residual of [B, H, W] u8 planes: rolls of the flat buffer;
    pixels ``i <= W`` stay verbatim (fusion_power_video.cc:564-572)."""
    b, h, w = plane.shape
    flat = plane.reshape(b, h * w)
    n = torch.roll(flat, w, dims=1)
    ww = torch.roll(flat, 1, dims=1)
    nw = torch.roll(flat, w + 1, dims=1)
    res = flat - clamped_gradient(n, ww, nw)
    res[:, : w + 1] = flat[:, : w + 1]
    return res.reshape(b, h, w)


def cg_flat_decode_ref(res: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K4: the inverse scan over the flat index, one step per
    pixel for the whole batch (fusion_power_video.cc:326-333).  ``w`` is
    the previous step's output and ``nw`` the previous step's ``n``."""
    b, r, x = res.shape
    out = res.reshape(b, r * x).clone()
    if r < 2:
        return out.reshape(b, r, x)
    flat = res.reshape(b, r * x)
    w = out[:, x]
    nw = out[:, 0]
    for i in range(x + 1, r * x):
        n = out[:, i - x]
        w = flat[:, i] + clamped_gradient(n, w, nw)
        out[:, i] = w
        nw = n
    return out.reshape(b, r, x)


def cg_flat_decode(res: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`cg_flat_encode` on [B, R, X] u8: K4 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if res.device.type == "cpu":
        return cg_flat_decode_ref(res)
    res = res.contiguous()
    kernels.check_cuda(res, torch.uint8, "res")
    b, r, x = res.shape
    out = torch.empty_like(res)
    if out.numel():
        kernels.launch("cg_flat_decode", "fpv1_cg_flat_decode", res.device,
                       res.data_ptr(), out.data_ptr(), b, r, x)
    return out

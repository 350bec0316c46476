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

import math

import torch

from fpv_tpu_torch.ops.predict import clamped_gradient
from fpv_tpu_torch.utils import kernels

__all__ = ["clamped_gradient", "cg_flat_decode", "cg_flat_decode_ref",
           "cg_flat_encode", "delta_decode", "delta_encode", "segment_length"]

TILE = 1024  # K4's tile: pixels of a chunk scanned at once (32 warps x 32)


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


def segment_length(x: int) -> int:
    """K4's segment length for rows of ``x`` pixels: ceil(sqrt(tile)) with
    a tile of min(x, TILE) pixels, rounded up to a multiple of 4 (phase C
    steps in blocks of 4), so a tile has at most 32 segments (one quarter
    warp each in phase A, one lane each in phase C) and its dependent
    depth 2L + S is near its least."""
    tile = min(x, TILE)
    seg = 4
    while seg * seg < tile:
        seg += 4
    return seg


def _cg_step(v: torch.Tensor, n: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """One pixel's map of the west value ``v`` (int32): r + CG(n, v, nw)
    mod 256 in the form v + clamp(n - v, min(0, d), max(0, d)), d = n - nw,
    which equals med3(n, v, v + d) and :func:`clamped_gradient`."""
    return (v + r + torch.clamp(n - v, lo, hi)) & 0xFF


def cg_flat_decode_ref(res: torch.Tensor,
                       seg_len: int | None = None) -> torch.Tensor:
    """Plain PyTorch K4: the inverse scan on the kernel's schedule
    (fusion_power_video.cc:326-333 computed as a scan of byte maps).

    The chain over the flat index i > W is cut into chunks of W pixels
    (chunk c starts at W + 1 + c*W; its n and nw are the previous chunk's
    outputs, so a chunk needs only finished pixels), and each chunk into
    segments of ``seg_len`` pixels (default :func:`segment_length`; other
    values for tests only).  Given the chunk above, pixel j maps the west
    value to its output, a map of one byte; per chunk:

    * phase A: each segment's composed map as a table of 256 entries, all
      start values stepped together ([B, S, 256], ``seg_len`` steps);
    * phase B: the segments' start values, one table lookup per segment;
    * phase C: each segment walked from its start value ([B, S]).

    Padding pixels (d = 0, r = 0) map every value to itself."""
    b, r, x = res.shape
    out = res.reshape(b, r * x).clone()
    if r < 2 or x == 0:
        return out.reshape(b, r, x)
    seg = seg_len or segment_length(x)
    flat = res.reshape(b, r * x).to(torch.int32)
    dev = res.device
    starts = torch.arange(256, dtype=torch.int32, device=dev)
    prev = flat[:, 1 : x + 1]  # the chunk above chunk 0: pixels 1..W
    pp_last = flat[:, 0]  # nw of chunk 0's first pixel
    w = flat[:, x]
    for lo in range(x + 1, r * x, x):
        npx = min(x, r * x - lo)
        nseg = -(-npx // seg)
        pad = nseg * seg - npx
        n = prev[:, :npx]
        nw = torch.cat([pp_last[:, None], prev[:, : npx - 1]], 1)
        d = torch.nn.functional.pad(n - nw, (0, pad)).view(b, nseg, seg)
        n = torch.nn.functional.pad(n, (0, pad)).view(b, nseg, seg)
        rr = torch.nn.functional.pad(flat[:, lo : lo + npx],
                                     (0, pad)).view(b, nseg, seg)
        dlo, dhi = torch.clamp(d, max=0), torch.clamp(d, min=0)
        v = starts.expand(b, nseg, 256)  # phase A
        for t in range(seg):
            v = _cg_step(v, n[..., t, None], dlo[..., t, None],
                         dhi[..., t, None], rr[..., t, None])
        ws = torch.empty(b, nseg, dtype=torch.int32, device=dev)
        for s in range(nseg):  # phase B
            ws[:, s] = w
            w = v[:, s].gather(1, w[:, None].long())[:, 0]
        cur = torch.empty(b, nseg, seg, dtype=torch.int32, device=dev)
        for t in range(seg):  # phase C
            ws = _cg_step(ws, n[..., t], dlo[..., t], dhi[..., t],
                          rr[..., t])
            cur[..., t] = ws
        cur = cur.view(b, nseg * seg)[:, :npx]
        out[:, lo : lo + npx] = cur.to(torch.uint8)
        pp_last = prev[:, x - 1]
        prev = cur
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

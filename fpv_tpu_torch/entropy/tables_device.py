"""On-device rANS table construction for the fused batch encode.

The batch encode normalizes its histograms where they were computed, so
only the finished tables travel to the host.  The tables are written into
the container verbatim; every float32 operation below is a separate op in
the JAX package's order (tables_device.py there), so both packages produce
the same tables and hence the same bytes.

Scheme: ``freq = 1 + largest_remainder(hist, PROB_SCALE - nfloor)`` over the
masked symbols, ties broken by symbol index (stable sorts), with a final
exact-sum correction on the first largest bin.
"""

from __future__ import annotations

import torch

from fpv_tpu_torch.ops.rans_layout import (
    CTX_ALPHA,
    CTX_NCTX,
    CTX_PROB_BITS,
    CTX_PROB_SCALE,
    PROB_BITS,
    PROB_SCALE,
)

_F32 = torch.float32


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=_F32, device=device)


def _ranks(key: torch.Tensor) -> torch.Tensor:
    """Rank of each key in descending order, ties by index (double stable
    argsort along the last axis)."""
    order = torch.argsort(-key, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True).to(torch.int32)


def normalize_freqs_device(
    hist: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """[256] int histogram -> [256] int64 freq table (sum PROB_SCALE).

    ``mask`` ([256] 0/1, optional) is an exact-support superset: symbols
    outside it get frequency 0.  Without a mask every symbol is floored."""
    dev = hist.device
    h = hist.to(_F32)
    if mask is None:
        maskf = torch.ones(256, dtype=_F32, device=dev)
        nfloor = _f32(256.0, dev)
    else:
        maskf = mask.to(_F32)
        nfloor = torch.sum(maskf)
    h = h * maskf
    total = torch.maximum(torch.sum(h), _f32(1.0, dev))
    scale = _f32(PROB_SCALE, dev) - nfloor
    ideal = h * (scale / total)
    # bias down so f32 rounding can't push floor above the exact value
    base = torch.floor(ideal * _f32(1.0 - 1e-6, dev)).to(torch.int32)
    base = torch.clamp(base, min=0)
    rem = ideal - base.to(_F32)
    d = scale.to(torch.int32) - torch.sum(base, dtype=torch.int32)
    key = (
        rem * _f32(512.0, dev)
        - torch.arange(256, dtype=_F32, device=dev) / _f32(256.0, dev)
        - (_f32(1.0, dev) - maskf) * _f32(1e9, dev)
    )
    rank = _ranks(key)
    extra = (rank < d).to(torch.int32) + (
        rank < d - nfloor.to(torch.int32)
    ).to(torch.int32)
    freq = (1 + base + extra) * maskf.to(torch.int32)
    resid = PROB_SCALE - torch.sum(freq, dtype=torch.int32)
    amax = torch.argmax(freq)
    freq = freq.clone()
    freq[amax] += resid
    return freq.to(torch.int64)


def normalize_freqs_ctx_device(
    hist: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """[NCTX*ALPHA] joint histogram -> [512] int64 per-context tables, each
    row summing to CTX_PROB_SCALE.  With a mask only masked pairs are
    floored; a context with an all-zero mask row gets a uniform table."""
    dev = hist.device
    h = hist.to(_F32).reshape(CTX_NCTX, CTX_ALPHA)
    if mask is None:
        maskf = torch.ones((CTX_NCTX, CTX_ALPHA), dtype=_F32, device=dev)
    else:
        maskf = mask.to(_F32).reshape(CTX_NCTX, CTX_ALPHA)
    nfloor = torch.sum(maskf, dim=1, keepdim=True)
    empty_row = nfloor < 0.5
    h = h * maskf
    total = torch.maximum(torch.sum(h, dim=1, keepdim=True), _f32(1.0, dev))
    scale = _f32(CTX_PROB_SCALE, dev) - nfloor
    ideal = h * (scale / total)
    base = torch.floor(ideal * _f32(1.0 - 1e-6, dev)).to(torch.int32)
    base = torch.clamp(base, min=0)
    rem = ideal - base.to(_F32)
    d = scale.to(torch.int32) - torch.sum(
        base, dim=1, keepdim=True, dtype=torch.int32
    )
    key = (
        rem * _f32(512.0, dev)
        - torch.arange(CTX_ALPHA, dtype=_F32, device=dev) / _f32(256.0, dev)
        - (_f32(1.0, dev) - maskf) * _f32(1e9, dev)
    )
    rank = _ranks(key)
    extra = (rank < d).to(torch.int32) + (
        rank < d - nfloor.to(torch.int32)
    ).to(torch.int32)
    freq = (1 + base + extra) * maskf.to(torch.int32)
    uniform = torch.full_like(freq, CTX_PROB_SCALE // CTX_ALPHA)
    freq = torch.where(empty_row, uniform, freq)
    resid = CTX_PROB_SCALE - torch.sum(freq, dim=1, keepdim=True,
                                       dtype=torch.int32)
    amax = torch.argmax(freq, dim=1)
    onehot = (
        torch.arange(CTX_ALPHA, device=dev)[None, :] == amax[:, None]
    ).to(torch.int32)
    freq = freq + resid * onehot
    return freq.reshape(-1).to(torch.int64)


def encode_tables_ctx_device(freq: torch.Tensor) -> torch.Tensor:
    """[NCTX*ALPHA] ctx tables -> [512] int32 fc = (f-1) | cum_within << 7."""
    f = freq.to(torch.int64).reshape(CTX_NCTX, CTX_ALPHA)
    cum = torch.cumsum(f, dim=1) - f
    fc = ((f - 1) & ((1 << CTX_PROB_BITS) - 1)) | (cum << CTX_PROB_BITS)
    return fc.reshape(-1).to(torch.int32)


def encode_tables_device(freq: torch.Tensor) -> torch.Tensor:
    """freq [256] -> [256] int32 fc = (f-1) | cum << 12 (the JAX version
    also returns f32 reciprocals for its TPU division; K1 divides exactly
    and needs none)."""
    f = freq.to(torch.int64)
    cum = torch.cumsum(f, dim=0) - f
    return (((f - 1) & 0xFFF) | (cum << PROB_BITS)).to(torch.int32)


def fused_decode_tables_device(freq: torch.Tensor) -> torch.Tensor:
    """freq [256] -> fused single-gather decode table [4096] int32 (u32
    bits): one entry per slot, ``off << 20 | (f-1) << 8 | sym``."""
    f = freq.to(torch.int64)
    cum_incl = torch.cumsum(f, dim=0)
    slots = torch.arange(PROB_SCALE, dtype=torch.int64, device=f.device)
    sym = torch.searchsorted(cum_incl, slots, right=True)
    off = slots - (cum_incl - f)[sym]
    entries = (off << 20) | ((f[sym] - 1) << 8) | sym
    return torch.where(entries >= 1 << 31, entries - (1 << 32),
                       entries).to(torch.int32)

"""rANS frequency-table construction (host side, numpy).

Used by the delta section, whose single-frame planes are normalized on the
host from exact or row-sampled histograms.
"""

from __future__ import annotations

import numpy as np

from fpv_tpu_torch.ops.rans_layout import (
    CTX_ALPHA,
    CTX_NCTX,
    CTX_PROB_SCALE,
    PROB_SCALE,
)


def ctx_tables(freq_ctx: np.ndarray):
    """[NCTX*ALPHA] per-context freqs (each ctx sums to CTX_PROB_SCALE) ->
    (freq u32 flat, cum-within-ctx u32 flat, sym_of_slot [NCTX*128])."""
    freq_ctx = np.asarray(freq_ctx, dtype=np.uint32).reshape(
        CTX_NCTX, CTX_ALPHA
    )
    cum = np.zeros_like(freq_ctx)
    cum[:, 1:] = np.cumsum(freq_ctx, axis=1)[:, :-1]
    sym_of_slot = np.concatenate(
        [
            np.repeat(np.arange(CTX_ALPHA, dtype=np.int32), freq_ctx[c])
            for c in range(CTX_NCTX)
        ]
    )
    return freq_ctx.reshape(-1), cum.reshape(-1), sym_of_slot


def normalize_freqs_ctx(
    hist: np.ndarray, floor_mask: np.ndarray | None = None
) -> np.ndarray:
    """[NCTX*ALPHA] joint histogram -> per-context tables, each summing to
    CTX_PROB_SCALE.

    Without ``floor_mask`` every symbol gets >= 1.  With a mask (an
    exact-support superset per (ctx, sym) pair) only masked pairs are
    floored and provably-absent pairs get frequency 0."""
    hist = np.asarray(hist, dtype=np.int64).reshape(CTX_NCTX, CTX_ALPHA)
    if floor_mask is not None:
        floor_mask = np.asarray(floor_mask, dtype=bool).reshape(
            CTX_NCTX, CTX_ALPHA
        )
    out = np.empty((CTX_NCTX, CTX_ALPHA), np.uint16)
    for c in range(CTX_NCTX):
        if floor_mask is not None and not floor_mask[c].any():
            # context never occurs: any valid row decodes (nothing coded)
            out[c] = np.full(CTX_ALPHA, CTX_PROB_SCALE // CTX_ALPHA, np.uint16)
            continue
        out[c] = normalize_freqs(
            hist[c],
            scale=CTX_PROB_SCALE,
            ensure_all=True,
            floor_mask=None if floor_mask is None else floor_mask[c],
        )
    return out.reshape(-1)


def normalize_freqs(
    hist: np.ndarray,
    scale: int = PROB_SCALE,
    ensure_all: bool = False,
    floor_mask: np.ndarray | None = None,
) -> np.ndarray:
    """Histogram -> frequency table summing to ``scale``; present symbols >= 1.

    Deterministic largest-remainder apportionment with index tie-break.
    ``ensure_all=True`` gives every symbol a nonzero frequency (the
    histogram may be sampled); ``floor_mask`` (an exact-support superset)
    restricts that floor to masked symbols and overrides ``ensure_all``.
    """
    hist = np.asarray(hist, dtype=np.int64)
    total = int(hist.sum())
    if total <= 0:
        if ensure_all or floor_mask is not None:
            # zero-pixel plane: nothing is coded, any valid table works
            return np.full(len(hist), scale // len(hist), dtype=np.uint16)
        raise ValueError("empty histogram")
    if floor_mask is not None:
        present = (hist > 0) | np.asarray(floor_mask, dtype=bool)
    else:
        present = (hist > 0) | ensure_all
    npresent = int(present.sum())
    if npresent > scale:
        raise ValueError("alphabet larger than probability scale")
    ideal = hist.astype(np.float64) * (scale / total)
    freq = np.floor(ideal).astype(np.int64)
    freq[present & (freq == 0)] = 1
    # fix the sum by distributing the difference to the largest-remainder bins
    diff = scale - int(freq.sum())
    if diff != 0:
        rema = ideal - np.floor(ideal)
        if diff > 0:
            order = np.lexsort((np.arange(len(hist)), -rema))
            order = order[present[order]]
            for i in range(diff):
                freq[order[i % len(order)]] += 1
        else:
            # remove from the largest bins, never below 1
            for _ in range(-diff):
                candidates = np.where(present & (freq > 1))[0]
                j = candidates[np.argmax(freq[candidates])]
                freq[j] -= 1
    if freq.sum() != scale:
        raise AssertionError("frequency table does not sum to scale")
    return freq.astype(np.uint16)

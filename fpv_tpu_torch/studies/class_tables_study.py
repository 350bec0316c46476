"""Per-temporal-class frequency tables study, on the port.

The counterpart of the JAX package's ``examples/class_tables_study.py``.
The format codes each plane batch with one shared frequency table (the
reference's single static table, fusion_power_video.cc:517-544, amortised
per batch), but a batch mixes residuals of two temporal classes: static or
frame0-delta frames and prev-frame chain frames, whose statistics differ.
Would a table per class (+512 wire bytes per extra table per plane)
recover 1% or more?

Method: the shipped decision procedure (temporal pick by exact
wraparound-|residual| with PREV_ANCHOR barring, then per-frame spatial
pick on the device: ``temporal_study``'s "prev" mode), then the chosen
residual planes priced three ways:

* shared:  one batch entropy over all frames               + 1 table
* split2:  entropy per class {static+delta, prev}           + 2 tables
* split3:  entropy per pick {none, frame0-delta, prev}      + 3 tables

``ops/rans_bound.class_tables_report`` measures the decode side of the
same question on the card.

    python -m fpv_tpu_torch.studies.class_tables_study [--fast]
        [--size N D] [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np

from fpv_tpu_torch.api.fpvt_codec import PREV_ANCHOR
from fpv_tpu_torch.studies.temporal_study import (
    best_spatial,
    corpora,
    fast_size,
    entropy_bits,
    planes_of,
    wrap_cost,
)
from fpv_tpu_torch.utils.platform import argv_device

TABLE_BITS = 512 * 8  # wire bytes per frequency table (format/fpvt.py)
CORPORA = ("plasma12s", "mixed12", "dark12", "drift12", "pan12")


def picked_residuals(plane: np.ndarray, delta: np.ndarray,
                     spatial: bool = True, device="cuda"):
    """The shipped decision procedure (temporal_study.code_plane,
    mode="prev") -> (chosen residual planes [B, H, W], pick [B]) with pick
    in {0: none, 1: frame0-delta, 2: prev}."""
    b = plane.shape[0]
    p16 = plane.astype(np.int16)
    prev = np.concatenate([delta[None], plane[:-1]], axis=0)
    cands = np.stack([
        plane,
        ((p16 - delta.astype(np.int16)) % 256).astype(np.uint8),
        ((p16 - prev.astype(np.int16)) % 256).astype(np.uint8),
    ])
    costs = np.stack([wrap_cost(c) for c in cands]).astype(np.float64)
    costs[2:, ::PREV_ANCHOR] = np.inf  # anchors: no chain candidates
    pick = costs.argmin(axis=0)
    chosen = cands[pick, np.arange(b)]
    if spatial:
        chosen = best_spatial(chosen, device)
    return chosen, pick


def price(chosen: np.ndarray, pick: np.ndarray, groups) -> float:
    """Total bits for the batch coded with one table per group of picks
    (a group with no frames costs nothing), with the tables' wire cost."""
    total = 0.0
    for g in groups:
        sel = np.isin(pick, g)
        if sel.any():
            total += entropy_bits(chosen[sel]) + TABLE_BITS
    return total


def study(name: str, frames: np.ndarray, shift: int, device="cuda") -> dict:
    high, low, pv = planes_of(frames, shift, device)
    shared = split2 = split3 = 0.0
    nprev = 0
    for plane, delta, spatial in (
        (high, high[0], True), (low, low[0], False),
    ):
        chosen, pick = picked_residuals(plane, delta, spatial, device)
        nprev += int((pick == 2).sum())
        shared += price(chosen, pick, [(0, 1, 2)])
        split2 += price(chosen, pick, [(0, 1), (2,)])
        split3 += price(chosen, pick, [(0,), (1,), (2,)])
    # previews: static-only in the format, the same under every variant
    pvb = entropy_bits(best_spatial(pv, device)) + TABLE_BITS
    shared += pvb
    split2 += pvb
    split3 += pvb
    return {
        "corpus": name,
        "prev_frames": nprev,
        "shared_bits": shared,
        "split2_bits": split2,
        "split3_bits": split3,
        "split2_save_pct": 100.0 * (1 - split2 / shared) if shared else 0.0,
        "split3_save_pct": 100.0 * (1 - split3 / shared) if shared else 0.0,
    }


def main(argv: list[str] | None = None) -> None:
    argv, dev = argv_device(argv, "class_tables_study")
    n, d = fast_size(argv, (16, 512))
    # Recorded result (16 x 512^2, the JAX study): per-class tables save
    # 0.7-3.8% of stream size (split2: plasma +0.92%, drift +0.72%, pan
    # +1.45%; split3: mixed +1.52%, dark +3.81%, pan +2.08%).  Not
    # shipped: the block layout mixes every class inside each decode step,
    # so per-class tables cost the decoder a per-lane table choice
    # (rans_bound.class_tables_report measures that on the card).
    print(f"{'corpus':<10} {'prevN':>5} {'shared kB':>10} {'split2 kB':>10} "
          f"{'save%':>7} {'split3 kB':>10} {'save%':>7}")
    for name, frames, shift in corpora(n, d, CORPORA):
        r = study(name, frames, shift, dev)
        print(f"{r['corpus']:<10} {r['prev_frames']:>5} "
              f"{r['shared_bits']/8192:10.1f} {r['split2_bits']/8192:10.1f} "
              f"{r['split2_save_pct']:7.2f} {r['split3_bits']/8192:10.1f} "
              f"{r['split3_save_pct']:7.2f}")


if __name__ == "__main__":
    main()

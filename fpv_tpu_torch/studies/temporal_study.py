"""Prev-frame (temporal) prediction study, on the port.

The counterpart of the JAX package's ``examples/temporal_study.py``: the
FPVT profile predicts frames against one static delta frame (the
reference's model, fusion_power_video.cc:517-544) or, since format v5,
against the previous frame (a mod-256 running sum along the frame axis to
invert).  This measures what the prev-frame candidate buys.

Method: for each bench corpus, every variant runs the same decision
procedure (per-frame temporal mode by exact wraparound-|residual| cost,
then per-frame spatial predictor none/up/CG2D by exact cost, on the
device), so the comparison isolates the temporal-candidate set:

* static: temporal mode in {none, frame0-delta}
* +prev:  {none, frame0-delta, prev-frame} (the shipped model)
* +lin:   +prev plus second-order extrapolation 2*prev - prev2, measured
  and rejected (see the note in :func:`main`)

Sizes are shared-table order-0 batch entropies of the high plane, the
low plane and the 1/16-scale preview plane.  Every PREV_ANCHOR-th frame
is barred from the chain-forming candidates, as the encoder bars it.

    python -m fpv_tpu_torch.studies.temporal_study [--fast] [--size N D]
        [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from fpv_tpu_torch.api.fpvt_codec import PREV_ANCHOR
from fpv_tpu_torch.ops.predict import cg2d_encode, up_encode
from fpv_tpu_torch.ops.preview import generate_preview
from fpv_tpu_torch.utils import testdata
from fpv_tpu_torch.utils.platform import argv_device


def fast_size(argv: list[str], full: tuple[int, int]) -> tuple[int, int]:
    """(frames, side) of a study's corpora: 4 x 128^2 with ``--fast``,
    ``--size N D``, else ``full``."""
    n, d = (4, 128) if "--fast" in argv else full
    if "--size" in argv:
        i = argv.index("--size")
        n, d = int(argv[i + 1]), int(argv[i + 2])
    return n, d


def entropy_bits(sym: np.ndarray) -> float:
    hist = np.bincount(sym.reshape(-1).astype(np.int64), minlength=256)
    n = hist.sum()
    if n == 0:
        return 0.0
    p = hist[hist > 0] / n
    return float(-(p * np.log2(p)).sum() * n)


def wrap_cost(res: np.ndarray) -> np.ndarray:
    """Per-frame exact wraparound-|residual| cost, [B]."""
    r = res.reshape(res.shape[0], -1).astype(np.int64)
    return np.minimum(r, 256 - r).sum(axis=1)


def best_spatial(plane: np.ndarray, device="cuda") -> np.ndarray:
    """Per-frame best of {none, up, CG2D} by exact cost (the model step's
    predictor set; exact instead of sampled) -> the chosen residual
    planes.  The predictors run on ``device``."""
    p = torch.from_numpy(np.ascontiguousarray(plane, dtype=np.uint8)).to(
        device)
    cands = np.stack(
        [plane, up_encode(p).cpu().numpy(), cg2d_encode(p).cpu().numpy()]
    )  # [3, B, H, W]
    costs = np.stack([wrap_cost(c) for c in cands])  # [3, B]
    pick = costs.argmin(axis=0)  # [B]
    return cands[pick, np.arange(plane.shape[0])]


def code_plane(plane: np.ndarray, delta: np.ndarray, mode: str,
               spatial: bool = True, device="cuda") -> float:
    """Model one byte plane batch: per-frame temporal mode (exact cost),
    then per-frame spatial mode, then shared-table batch entropy (bits).

    ``mode``: "static" = {none, frame0-delta}; "prev" adds the prev-frame
    candidate; "lin" further adds 2*prev - prev2 (mod 256 per byte
    plane).  Anchor frames (every PREV_ANCHOR-th) take no chain
    candidate, and "lin" at anchor+1 none either (it would read across
    the anchor)."""
    b = plane.shape[0]
    p16 = plane.astype(np.int16)
    cands = [plane, (p16 - delta.astype(np.int16)) % 256]
    if mode in ("prev", "lin"):
        prev = np.concatenate([delta[None], plane[:-1]], axis=0)
        cands.append((p16 - prev.astype(np.int16)) % 256)
    if mode == "lin" and b >= 2:
        prev = np.concatenate([delta[None], plane[:-1]], 0).astype(np.int32)
        prev2 = np.concatenate([delta[None], delta[None], plane[:-2]],
                               0)[:b].astype(np.int32)
        pred = (2 * prev - prev2) % 256
        cands.append((plane.astype(np.int32) - pred) % 256)
    cands = np.stack([c.astype(np.uint8) for c in cands])
    costs = np.stack([wrap_cost(c) for c in cands]).astype(np.float64)
    costs[2:, ::PREV_ANCHOR] = np.inf  # anchor frames: no chain candidates
    if costs.shape[0] > 3:
        costs[3, 1::PREV_ANCHOR] = np.inf
    pick = costs.argmin(axis=0)
    chosen = cands[pick, np.arange(b)]
    if spatial:
        chosen = best_spatial(chosen, device)
    return entropy_bits(chosen)


def planes_of(frames: np.ndarray, shift: int, device="cuda"):
    """(high, low, preview) u8 planes of frames shifted left by ``shift``;
    the previews are made on ``device``."""
    imgs = (frames.astype(np.uint16) << shift).astype(np.uint16)
    high = (imgs >> 8).astype(np.uint8)
    low = (imgs & 0xFF).astype(np.uint8)
    pv = generate_preview(torch.from_numpy(high).to(device)).cpu().numpy()
    return high, low, pv


def study(name: str, frames: np.ndarray, shift: int, device="cuda") -> dict:
    high, low, pv = planes_of(frames, shift, device)
    res = {"corpus": name}
    total = {}
    for mode in ("static", "prev", "lin"):
        hb = code_plane(high, high[0], mode, device=device)
        lb = code_plane(low, low[0], mode, spatial=False, device=device)
        # previews are never prev-predicted (they stay decodable alone)
        pb = code_plane(pv, pv[0], "static", device=device)
        res[f"{mode}_high_bits"] = hb
        res[f"{mode}_low_bits"] = lb
        res[f"{mode}_pv_bits"] = pb
        total[mode] = hb + lb + pb
    res["static_total_bits"] = total["static"]
    res["prev_total_bits"] = total["prev"]
    res["lin_total_bits"] = total["lin"]
    res["save_pct"] = (
        100.0 * (1 - total["prev"] / total["static"])
        if total["static"] > 0 else 0.0
    )
    res["lin_vs_prev_pct"] = (
        100.0 * (1 - total["lin"] / total["prev"])
        if total["prev"] > 0 else 0.0
    )
    return res


def pan_frames(n: int, d: int, step: float = 0.4, seed: int = 5) -> np.ndarray:
    """Smooth sub-pixel pan: one plasma field sampled at a fractional
    offset that advances ``step`` px/frame (bilinear interpolation)."""
    base = testdata.plasma_frames(1, d * 2, d * 2, bits=12, seed=seed)[0]
    base = base.astype(np.float64)
    out = np.empty((n, d, d), np.uint16)
    for i in range(n):
        off = i * step
        i0, f = int(np.floor(off)), off - np.floor(off)
        a = base[i0:i0 + d, i0:i0 + d]
        b = base[i0 + 1:i0 + 1 + d, i0:i0 + d]
        c = base[i0:i0 + d, i0 + 1:i0 + 1 + d]
        e = base[i0 + 1:i0 + 1 + d, i0 + 1:i0 + 1 + d]
        out[i] = np.clip((a * (1 - f) * (1 - f) + b * f * (1 - f)
                          + c * (1 - f) * f + e * f * f), 0, 4095
                         ).astype(np.uint16)
    return out


def corpora(n: int, d: int, names: tuple[str, ...]) -> list:
    """The bench corpora of the studies, (name, frames, shift) for each
    of ``names`` in order: plasma12s, noise16, ramp12s, mixed12, dark12,
    drift12, pan12 (the random ones drawn from one seeded generator, in
    the JAX examples' order, whichever are asked for)."""
    rng = np.random.default_rng(0)
    pl = testdata.plasma_frames(n, d, d, bits=12, seed=5).astype(np.int32)
    dark = rng.poisson(50, (n, d, d)).astype(np.uint16)
    dark[rng.random((n, d, d)) < 1e-4] = 4000
    mixed = np.clip(pl + rng.normal(0, 8, pl.shape), 0, 4095).astype(
        np.uint16)
    make = {
        "plasma12s": lambda: testdata.plasma_frames(n, d, d, bits=12,
                                                    seed=5),
        "noise16": lambda: testdata.noise_frames(n, d, d, bits=16),
        "ramp12s": lambda: np.tile((np.arange(d * d) % 4096)
                                   .astype(np.uint16).reshape(1, d, d),
                                   (n, 1, 1)),
        "mixed12": lambda: mixed,
        "dark12": lambda: dark,
        "drift12": lambda: np.stack([np.roll(pl[0], (i, i), (0, 1))
                                     for i in range(n)]).astype(np.uint16),
        "pan12": lambda: pan_frames(n, d),
    }
    shifts = {"noise16": 0}
    return [(name, make[name](), shifts.get(name, 4)) for name in names]


CORPORA = ("plasma12s", "noise16", "ramp12s", "mixed12", "dark12",
           "drift12", "pan12")


def main(argv: list[str] | None = None) -> None:
    argv, dev = argv_device(argv, "temporal_study")
    n, d = fast_size(argv, (16, 512))
    # The "lin" column is a recorded negative result: adding 2*prev -
    # prev2 as a 4th temporal mode wins the wrap-|residual| decision on
    # every drifting corpus, yet the coded size grows (16 x 256^2: plasma
    # -7.0%, mixed -7.2%, drift -10.9% against prev): on independently
    # wrapping byte planes the second difference doubles carry noise and
    # smears the shared table.  Only the noise-free pan12 gains (+11.4%),
    # and sensor noise of 0.5/1/2 DN takes that to +6.1/+0.8/-4.0%.
    print(f"{'corpus':<10} {'static kB':>10} {'+prev kB':>10} {'save%':>7} "
          f"{'+lin kB':>9} {'lin_vs_prev%':>12}")
    for name, frames, shift in corpora(n, d, CORPORA):
        r = study(name, frames, shift, dev)
        print(f"{r['corpus']:<10} {r['static_total_bits']/8192:10.1f} "
              f"{r['prev_total_bits']/8192:10.1f} {r['save_pct']:7.2f} "
              f"{r['lin_total_bits']/8192:9.1f} {r['lin_vs_prev_pct']:12.2f}")


if __name__ == "__main__":
    main()

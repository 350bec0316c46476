"""High-plane context-model study, on the port.

The counterpart of the JAX package's ``examples/ctx_study.py``: how much a
conditional entropy model on the HIGH plane could save over the shipping
order-0 tables, before paying for a kernel.  Contexts:

* prev-step  -- the symbol 1024 flat positions back: the only context the
  block-interleaved decoder gets for free (the previous step's decoded
  vector, the mechanism of the low plane's ctx16 coding).
* W-neighbor -- flat position -1: spatially adjacent, but not available
  to the decoder (lanes decode 1024 consecutive positions at once).
* W+N joint  -- the classic 2-D context, decoder-infeasible here; a dream
  bound.

Symbols are the coded high plane: ``encode_model_step``'s output on the
device (delta and spatial prediction applied, the encoder's decisions).
Context values are bucketed by residual magnitude (8 log2 buckets);
conditional entropies include the per-context table cost a stream would
carry (nctx*256 12-bit probabilities).

    python -m fpv_tpu_torch.studies.ctx_study [--fast] [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from fpv_tpu_torch.api.fpvt_codec import encode_model_step, put_frames
from fpv_tpu_torch.studies.temporal_study import corpora, fast_size
from fpv_tpu_torch.utils.platform import argv_device

CORPORA = ("plasma12s", "noise16", "ramp12s", "mixed12", "dark12",
           "drift12")


def bucket(sym: np.ndarray) -> np.ndarray:
    """Residual-magnitude log2 buckets: 8 contexts."""
    m = np.minimum(sym.astype(np.int32), 256 - sym.astype(np.int32))
    # 0,1,2,3-4,5-8,9-16,17-32,>32
    return np.digitize(m, [1, 2, 3, 5, 9, 17, 33]).astype(np.int32)


def entropy_bits(hist: np.ndarray) -> float:
    n = hist.sum()
    if n == 0:
        return 0.0
    p = hist[hist > 0] / n
    return float(-(p * np.log2(p)).sum() * n)


def cond_entropy_bits(ctx: np.ndarray, sym: np.ndarray, nctx: int) -> float:
    joint = np.zeros((nctx, 256), np.int64)
    np.add.at(joint, (ctx, sym), 1)
    return sum(entropy_bits(joint[c]) for c in range(nctx))


def study(name: str, frames: np.ndarray, shift: int, device="cuda") -> dict:
    imgs = put_frames((frames << shift).astype(np.uint16), device)
    delta = imgs[0]
    dh, dl = (delta >> 8).to(torch.uint8), (delta & 0xFF).to(torch.uint8)
    out = encode_model_step(imgs, dh, dl, shift=0)
    high = out["high"].cpu().numpy().astype(np.uint8)
    b = high.shape[0]
    flat = high.reshape(b, -1)  # per-frame flat stream, scan order
    s = flat.reshape(-1).astype(np.int64)
    n = s.size
    h0 = entropy_bits(np.bincount(s, minlength=256))

    # prev-step context: flat position -1024 within each frame (step 0
    # sees zeros, as the kernels' history starts at zero)
    prev = np.zeros_like(flat)
    prev[:, 1024:] = flat[:, :-1024]
    cw = np.zeros_like(flat)
    cw[:, 1:] = flat[:, :-1]
    w_img = high.shape[2]
    cn = np.zeros_like(flat)
    cn[:, w_img:] = flat[:, :-w_img]

    nctx = 8
    res = {"corpus": name, "syms": n, "order0_bps": h0 / n}
    for label, carr, nc in (
        ("prev_step", bucket(prev.reshape(-1)), nctx),
        ("w_neighbor", bucket(cw.reshape(-1)), nctx),
        ("wn_joint", bucket(cw.reshape(-1)) * nctx + bucket(cn.reshape(-1)),
         nctx * nctx),
    ):
        hc = cond_entropy_bits(carr, s, nc) + nc * 256 * 12
        res[label + "_bps"] = hc / n
        # h0 == 0: a constant residual plane (CODING_CONST), no saving
        res[label + "_save_pct"] = (
            100.0 * (1 - hc / h0) if h0 > 0 else 0.0
        )
    return res


def main(argv: list[str] | None = None) -> None:
    argv, dev = argv_device(argv, "ctx_study")
    # --fast: tiny corpora; the full size is the JAX study's recorded one
    n, d = fast_size(argv, (16, 512))
    print(f"{'corpus':<10} {'order0':>7} {'prev':>7} {'save%':>6} "
          f"{'W':>7} {'save%':>6} {'W+N':>7} {'save%':>6}")
    for name, frames, shift in corpora(n, d, CORPORA):
        r = study(name, frames, shift, dev)
        print(f"{r['corpus']:<10} {r['order0_bps']:7.4f} "
              f"{r['prev_step_bps']:7.4f} {r['prev_step_save_pct']:6.2f} "
              f"{r['w_neighbor_bps']:7.4f} {r['w_neighbor_save_pct']:6.2f} "
              f"{r['wn_joint_bps']:7.4f} {r['wn_joint_save_pct']:6.2f}")


if __name__ == "__main__":
    main()

"""Bit-exact predictor-decision heuristics of the FPV1 profile.

The reference encoder decides per frame whether to apply delta prediction
and clamped-gradient prediction from sampled 256-bin histograms and an
integer entropy estimate (fusion_power_video.cc:216-244, 517-564).  Byte
identity needs the same decisions, integer quirks included:

* ``approxLog2(v)`` is ``floor(log2(v))`` (fusion_power_video.cc:216-232);
  zero-count bins contribute ``0 * (...) == 0``.
* ``EstimateEntropy`` (fusion_power_video.cc:235-244) accumulates in a C
  ``int`` (int32): the sum of ``v * (log2sum - approxLog2(v))`` is taken
  mod 2^32 and sign-extended to uint64, and the result is
  ``(1024 * sumOfLogs) mod 2^64 // sum`` in uint64 arithmetic.
* The delta heuristic (fusion_power_video.cc:522-533) histograms a
  "difference" that is always 0, so delta prediction is applied unless the
  sampled original histogram itself has entropy 0.

The histograms are sampled on the device for a whole batch in one
``bincount`` (:func:`decision_counts`); the entropy estimate stays on the
host in Python ints, because it needs an unsigned 64-bit division that
torch tensors do not have.
"""

from __future__ import annotations

import numpy as np
import torch

from fpv_tpu_torch.ops.predict import clamped_gradient

_MASK32 = (1 << 32) - 1
_MASK64 = (1 << 64) - 1

DELTA_SKIP = 15  # decide_delta samples flat[0::15]
CG_SKIP = 31  # decide_cg samples flat[W+1::31]


def approx_log2(v: int) -> int:
    """floor(log2(v)) for v >= 1 (reference fusion_power_video.cc:216-232)."""
    if v <= 0:
        raise ValueError("approx_log2 requires v >= 1")
    return v.bit_length() - 1


def estimate_entropy(counts) -> int:
    """Integer entropy estimate of a 256-bin histogram, as the uint64 value
    the reference computes (int32 accumulator narrowing included)."""
    counts = [int(c) for c in counts]
    sum_ = 0
    for c in counts:  # std::accumulate(..., 0): an int accumulator
        sum_ = (sum_ + c) & _MASK32
        if sum_ >= 1 << 31:
            sum_ -= 1 << 32
    if sum_ == 0:
        return 0
    sum_u64 = sum_ & _MASK64  # size_t conversion (sign extension)
    log2sum = approx_log2(sum_ if sum_ > 0 else sum_u64)
    total = sum(v * (log2sum - approx_log2(v)) for v in counts if v)
    acc32 = total & _MASK32
    if acc32 >= 1 << 31:
        acc32 -= 1 << 32  # int32 narrowing
    sum_of_logs = acc32 & _MASK64  # size_t sumOfLogs = (sign-extended) acc
    return ((1024 * sum_of_logs) & _MASK64) // sum_u64


def decide_delta(counta) -> bool:
    """Delta decision from the histogram of ``high.flat[0::15]``: the
    reference's sampled "difference" histogram holds every sample in bin
    0 (fusion_power_video.cc:522-533)."""
    countd = np.zeros(256, np.int64)
    countd[0] = int(np.sum(counta))
    return estimate_entropy(countd) < estimate_entropy(counta)


def decide_cg(counta, countb) -> bool:
    """CG decision (fusion_power_video.cc:546-564): residual entropy
    against the entropy of the sampled values."""
    return estimate_entropy(countb) < estimate_entropy(counta)


def decision_counts(
    high: torch.Tensor, delta_coded: torch.Tensor | None = None
) -> torch.Tensor:
    """[B, H, W] u8 high planes -> int64 [B, K, 256] sampled histograms on
    their device, in one ``bincount``:

    * row 0: ``flat[0::15]`` (the delta decision's sample);
    * rows 1, 2: the values ``flat[i]`` and the flat clamped-gradient
      residuals at ``i = W+1, W+32, ...`` (the CG decision's samples);
    * with ``delta_coded`` (``high`` minus the delta frame's high plane),
      rows 3, 4: rows 1, 2 of it, the plane the CG decision sees once
      delta prediction is taken.
    """
    b, h, w = high.shape
    dev = high.device
    flat = high.reshape(b, h * w)
    rows = [flat[:, 0::DELTA_SKIP]]
    idx = torch.arange(w + 1, max(h * w, w + 1), CG_SKIP, device=dev)
    planes = [flat]
    if delta_coded is not None:
        planes.append(delta_coded.reshape(b, h * w))
    for p in planes:
        a = p[:, idx]
        pred = clamped_gradient(p[:, idx - w], p[:, idx - 1],
                                p[:, idx - w - 1])
        rows += [a, a - pred]
    k = len(rows)
    offs = torch.arange(b * k, device=dev).reshape(b, k) * 256
    vals = torch.cat([(r.to(torch.int64) + offs[:, j : j + 1]).reshape(-1)
                      for j, r in enumerate(rows)])
    return torch.bincount(vals, minlength=b * k * 256).reshape(b, k, 256)


def decide(counts: np.ndarray, with_delta: bool) -> tuple[list, list]:
    """Per-frame (use_delta, use_cg) from :func:`decision_counts`'s host
    counts; ``with_delta`` says whether a delta frame exists (rows 3, 4)."""
    use_delta, use_cg = [], []
    for c in counts:
        d = with_delta and decide_delta(c[0])
        use_delta.append(d)
        use_cg.append(decide_cg(*(c[3:5] if d else c[1:3])))
    return use_delta, use_cg

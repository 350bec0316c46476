"""Camera recordings made from a seed, on the device.

The content is the codec's synthetic "plasma" corpus (the formula of
``fpv_tpu_torch/utils/testdata.plasma_frames``, frozen here): a static
background of sines, a bright Gaussian blob drifting along a fixed path,
and uniform sensor noise in [0, noise).  The path and background are the
same for every seed; the noise comes from a ``torch.Generator`` seeded
with the recording's seed, so two seeds give two recordings of the same
scene and the same cost to code.  Values are right-aligned camera samples
of ``bits`` bits in uint16.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def plasma(n: int, h: int, w: int, bits: int, noise: int, seed: int,
           device) -> torch.Tensor:
    """[n, h, w] int32 samples in [0, 2^bits) on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    maxval = (1 << bits) - 1
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    background = (torch.sin(xx / 17.0) + torch.cos(yy / 23.0) + 2.0) * (
        0.12 * maxval)
    sigma = max(h, w) / 6.0
    out = torch.empty((n, h, w), dtype=torch.int32, device=dev)
    for i in range(n):
        cx = w * (0.3 + 0.4 * math.sin(i * 0.3))
        cy = h * (0.5 + 0.3 * math.cos(i * 0.2))
        blob = (0.6 * maxval) * torch.exp(
            -((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma**2))
        img = background + blob
        if noise:
            img = img + torch.randint(0, noise, (h, w), generator=gen,
                                      device=dev, dtype=torch.int32)
        out[i] = img.clamp(0, maxval).to(torch.int32)
    return out


def recording_seeds(seed: int, count: int) -> list[int]:
    """``count`` distinct 63-bit seeds derived from the run's seed."""
    ss = np.random.SeedSequence([abs(seed), int(seed < 0)])
    return [int(s) for s in ss.generate_state(count, np.uint64) >> 1]


def to_host(frames: torch.Tensor) -> np.ndarray:
    """int32 samples -> host uint16 frames, as a camera hands them over
    (carried as int16 words, so only two bytes a pixel cross the bus)."""
    words = torch.where(frames >= 32768, frames - 65536, frames)
    return words.to(torch.int16).cpu().numpy().view(np.uint16)

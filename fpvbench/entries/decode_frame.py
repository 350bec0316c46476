"""``decode_frame``: one client asks one open ``fpv_tpu_torch.FpvtReader``
for one frame at a time (``decode_frame(i)``), the frame drawn uniformly
from the file by the seed; the next request goes when the last answer is
in.  Every answer is compared when it comes, outside the request's time.

Traffic keys: none.  Reports ``frame_p95_ms`` (its median and count on
standard error)."""

from __future__ import annotations

import numpy as np

from fpvbench.harness import log, mismatch

KEYS: dict = {}
SPAN = "request"


class Entry:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.counts = dict(requests=0)
        self.frames_wrong = self.pixels_wrong = 0

    def setup(self) -> None:
        ctx = self.ctx
        self.reader = ctx.codec.FpvtReader(ctx.encode(ctx.recordings[0]),
                                           device=ctx.device)
        self.want = ctx.expected(0)
        n = len(self.want)
        self.order = ctx.rng.integers(0, n, size=1 << 20)
        # the warm-up takes the timed path, every frame's chain once
        for i in ctx.rng.permutation(n):
            self.decode(int(i))

    def decode(self, i: int):
        return self.ctx.faults.decoded(self.reader.decode_frame(i))

    def call(self, i: int):
        j = int(self.order[i % len(self.order)])
        return j, self.decode(j)

    def after(self, result) -> None:
        j, out = result
        bad = mismatch(out, self.want[j])
        self.frames_wrong += bad > 0
        self.pixels_wrong += bad
        self.counts["requests"] += 1

    def release(self) -> None:
        del self.reader

    def end_to_end(self, window_s: float, latencies) -> dict:
        ms = np.asarray(latencies) * 1e3
        log(f"seek: {len(ms)} requests, median {np.median(ms)} ms, "
            f"p95 {np.percentile(ms, 95)} ms")
        return {"frame_p95_ms": float(np.percentile(ms, 95))}

    def check(self) -> dict:
        return {"frames_wrong": self.frames_wrong,
                "pixels_wrong": self.pixels_wrong}

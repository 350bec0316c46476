"""``decode_file``: one whole file decoded a call, host to host, with
``fpv_tpu_torch.decode_file_fpvt`` and a fresh reader each call (FPVT
bytes in, numpy frames out); the files, one a recording, are encoded in
set-up and take turns.

Traffic keys: ``checked_outputs``, how many decoded recordings (drawn
from the seed among all the window returned) the check compares whole.
Reports ``decode_mpix_s`` and ``bits_per_pixel`` (the bytes of the files
decoded, on disk, per pixel: a faster decode bought with bigger files
shows there)."""

from __future__ import annotations

from fpvbench import bytecount
from fpvbench.harness import Reservoir, mismatch
from fpvbench.reference import fpvt as ref

KEYS = {"checked_outputs": int}
SPAN = "pass"


class Entry:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.pixels = self.bytes = 0
        self.counts = dict(batches=0, k2_bytes=0)
        self.sample = Reservoir(ctx.mix["checked_outputs"], ctx.rng)
        self.files: list[bytes] = []
        self.k2: list[tuple[int, int]] = []  # (batches, K2 bytes) per file

    def setup(self) -> None:
        for rec in self.ctx.recordings:
            data = self.ctx.encode(rec)
            f = ref.parse(data, headers_only=True)
            self.k2.append((len(f.batches), sum(
                bytecount.k2_bytes(s) for s in ref.stream_geometry(f)
                if not s["name"].endswith("preview"))))
            self.files.append(data)
        for data in self.files:  # the warm-up takes the timed path
            self.decode(data)

    def decode(self, data: bytes):
        return self.ctx.faults.decoded(self.ctx.codec.decode_file_fpvt(
            data, device=self.ctx.device))

    def call(self, i: int):
        r = i % len(self.files)
        out = self.decode(self.files[r])
        self.pixels += self.ctx.recordings[r].size
        self.bytes += len(self.files[r])
        return r, out

    def after(self, result) -> None:
        self.sample.offer(result)
        r = result[0]
        self.counts["batches"] += self.k2[r][0]
        self.counts["k2_bytes"] += self.k2[r][1]

    def end_to_end(self, window_s: float, latencies) -> dict:
        return {"decode_mpix_s": self.pixels / window_s / 1e6,
                "bits_per_pixel": 8 * self.bytes / max(self.pixels, 1)}

    def check(self) -> dict:
        wrong = sum(mismatch(out, self.ctx.expected(r))
                    for r, out in self.sample.items)
        return {"pixels_wrong": wrong}

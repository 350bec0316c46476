"""``encode_file``: one recording encoded a call, host to host, with
``fpv_tpu_torch.encode_file_fpvt`` at the configuration's settings (numpy
frames in, a whole FPVT file out); the recordings take turns.

Traffic keys: ``checked_outputs``, how many files (drawn from the seed
among all the window wrote) the plain reference decodes in the check.
Reports ``encode_mpix_s`` and ``bits_per_pixel``."""

from __future__ import annotations

import numpy as np
import torch

from fpvbench import bytecount
from fpvbench.harness import Reservoir, log
from fpvbench.reference import fpvt as ref

KEYS = {"checked_outputs": int}
SPAN = "pass"


class Entry:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.pixels = self.bytes = 0
        self.counts = dict(batches=0, k1_bytes=0)
        self.sample = Reservoir(ctx.mix["checked_outputs"], ctx.rng)

    def setup(self) -> None:
        for rec in self.ctx.recordings:  # the warm-up takes the timed path
            self.encode(rec)

    def encode(self, frames):
        faults = self.ctx.faults
        return faults.encoded(self.ctx.encode(faults.frames_in(frames)))

    def call(self, i: int):
        ctx = self.ctx
        r = i % len(ctx.recordings)
        out = self.encode(ctx.recordings[r])
        self.pixels += ctx.recordings[r].size
        self.bytes += len(out)
        return r, out

    def after(self, result) -> None:
        self.sample.offer(result)
        if self.ctx.trace:
            f = ref.parse(result[1], headers_only=True)
            self.counts["batches"] += len(f.batches)
            self.counts["k1_bytes"] += sum(
                bytecount.k1_bytes(s) for s in ref.stream_geometry(f))

    def end_to_end(self, window_s: float, latencies) -> dict:
        return {"encode_mpix_s": self.pixels / window_s / 1e6,
                "bits_per_pixel": 8 * self.bytes / max(self.pixels, 1)}

    def check(self) -> dict:
        """Each sampled file decoded by the plain reference: its frames must
        be the recording's, its previews the recording's previews."""
        wrong = pv_wrong = faults = unreadable = 0
        parsed = []
        for r, data in self.sample.items:
            try:
                parsed.append((r, ref.parse(data)))
            except ref.FormatError as e:
                log(f"check: sampled file unreadable: {e}")
                unreadable += 1
        try:
            decoded = ref.decode_files([f for _r, f in parsed],
                                       self.ctx.device)
        except ref.FormatError as e:
            log(f"check: sampled files undecodable: {e}")
            unreadable += len(parsed)
            decoded = []
        for (r, _f), dec in zip(parsed, decoded):
            want = torch.from_numpy(self.ctx.expected(r).view(np.int16)).to(
                self.ctx.device).to(torch.int32) & 0xFFFF
            faults += dec.faults
            if dec.frames.shape != want.shape:
                wrong += want.numel()
                pv_wrong += want.numel() // 16
                continue
            wrong += int((dec.frames != want).sum())
            pv_want = ref.box_preview((want[1:] >> 8).to(torch.uint8))
            if dec.previews.shape != pv_want.shape:
                pv_wrong += pv_want.numel()
            else:
                pv_wrong += int((dec.previews != pv_want).sum())
        return {"pixels_wrong": wrong, "previews_wrong": pv_wrong,
                "stream_faults": faults, "files_unreadable": unreadable}

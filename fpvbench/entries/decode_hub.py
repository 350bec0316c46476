"""``decode_hub``: one plasma shot a call through one long-lived
``fpv_tpu_torch.MultiStreamDecoder``.  A shot is the configuration's
``streams`` cameras (1 where it names none), one FPVT file a camera, a
recording each, encoded in set-up; the recordings' shots take turns.  A
call adds the shot's streams under fresh ids, feeds their files in
``chunk_bytes`` slices (``memoryview``s of the files) round-robin, one
chunk a stream in turn, as a receiver of the cameras' links sees them,
then ends each stream; the next shot goes when the last stream has ended
(one client, closed loop).  The hub delivers host frames; no upload cache,
no previews.  Set-up runs every shot once through the hub.

Traffic keys: ``chunk_bytes``; ``checked_outputs``, how many shots (drawn
from the seed among all the window ran) the check compares whole: the
frames the hub hands over for them are kept (each batch's frames are a
buffer of their own), no other shot's.  Every shot, each
stream must deliver its recording's frames with the file's timestamps, in
order.  Reports ``decode_mpix_s`` (the pixels of the frames delivered)
and ``bits_per_pixel`` (the bytes fed per pixel).  ``counts``: ``batches``
and ``k2_bytes`` as ``decode_file`` counts them, and the hub's counters
(``MultiStreamDecoder.stats``) under ``hub.<name>``, counted from the end
of the window's first shot: the issue worker's wait across the window's
start (the profiler's start-up, in a traced run) is no wait of the
hub's."""

from __future__ import annotations

import gc

import numpy as np

from fpvbench import bytecount
from fpvbench.harness import Reservoir, log, mismatch
from fpvbench.reference import fpvt as ref
from fpvbench.reference.multistream import timestamps

KEYS = {"chunk_bytes": int, "checked_outputs": int}
SPAN = "pass"


class Stream:
    """One camera stream of a shot, as its frames arrive: its recording,
    whether its answers are kept for the check and whether they pass
    through ctx.faults."""

    def __init__(self, recording: int, keep: bool, timed: bool) -> None:
        self.recording, self.keep, self.timed = recording, keep, timed
        self.frames = 0
        self.stamps: list[np.ndarray] = []
        self.kept: list[np.ndarray] = []


class Entry:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        cfg, mix = ctx.cfg, ctx.mix
        self.streams = cfg.get("streams", 1)
        if len(ctx.recordings) % self.streams:
            raise ValueError("the recordings do not make whole shots")
        self.shots = [list(range(s, s + self.streams))
                      for s in range(0, len(ctx.recordings), self.streams)]
        self.chunk = mix["chunk_bytes"]
        self.pixels = self.bytes = self.streams_wrong = 0
        self.counts = dict(batches=0, k2_bytes=0)
        self.sample = Reservoir(mix["checked_outputs"], ctx.rng)
        self.kept: list[list[Stream] | None] = []  # sampled shots, by slot
        self.live: dict[str, Stream] = {}
        self.stats0: dict | None = None
        self.files: list[bytes] = []
        self.stamps: list[np.ndarray] = []
        self.k2: list[tuple[int, int]] = []  # (batches, K2 bytes) per file

    def setup(self) -> None:
        ctx = self.ctx
        self.hub = ctx.codec.MultiStreamDecoder(sink=self.sink,
                                                devices=[ctx.device])
        # a hub without end_stream fails here, before the encodes
        self.end_stream = self.hub.end_stream
        for rec in ctx.recordings:
            data = ctx.encode(rec)
            f = ref.parse(data, headers_only=True)
            self.k2.append((len(f.batches), sum(
                bytecount.k2_bytes(s) for s in ref.stream_geometry(f)
                if not s["name"].endswith("preview"))))
            self.stamps.append(timestamps(f))
            self.files.append(data)
        # every shot once, the first kept as a sampled shot is while the
        # others run (the window holds one sampled shot's frames besides
        # those in flight: the host's cache of pinned buffers grows to that
        # here), and set-up's garbage collected before the window
        held = self.shot(self.shots[0], "warm-up0", keep=True, timed=False)
        for j, recordings in enumerate(self.shots[1:], 1):
            self.shot(recordings, f"warm-up{j}", keep=False, timed=False)
        del held
        gc.collect()

    def sink(self, sid: str, frames: np.ndarray, ts: np.ndarray) -> None:
        st = self.live[sid]
        if st.timed:
            frames = self.ctx.faults.decoded(frames)
        if st.keep:
            st.kept.append(frames)
        st.frames += len(frames)
        st.stamps.append(ts)

    def shot(self, recordings: list[int], tag: str, keep: bool,
             timed: bool) -> list[Stream]:
        """Feed one shot's files through the hub, interleaved, and end
        every stream: its frames have all reached the sink."""
        ids = [f"cam{j}.{tag}" for j in range(len(recordings))]
        for sid, r in zip(ids, recordings):
            self.live[sid] = Stream(r, keep, timed)
            self.hub.add_stream(sid)
        views = [memoryview(self.files[r]) for r in recordings]
        for off in range(0, max(len(v) for v in views), self.chunk):
            for sid, v in zip(ids, views):
                if off < len(v):
                    self.hub.feed(sid, v[off : off + self.chunk])
        for sid in ids:
            self.end_stream(sid)
        return [self.live.pop(sid) for sid in ids]

    def call(self, i: int):
        self.sample.offer(i)
        slot = self.sample.items.index(i) if i in self.sample.items else None
        if slot is not None:
            # the shot it replaces lets go of its frames first
            self.kept[slot:slot + 1] = [None]
        streams = self.shot(self.shots[i % len(self.shots)], str(i),
                            slot is not None, True)
        if slot is not None:
            self.kept[slot] = streams
        return streams

    def after(self, streams: list[Stream]) -> None:
        h, w = self.ctx.recordings[0].shape[1:]
        for st in streams:
            got = np.concatenate(st.stamps) if st.stamps else None
            want = self.stamps[st.recording]
            self.streams_wrong += not (
                st.frames == len(want) and np.array_equal(got, want))
            self.pixels += st.frames * h * w
            self.bytes += len(self.files[st.recording])
            self.counts["batches"] += self.k2[st.recording][0]
            self.counts["k2_bytes"] += self.k2[st.recording][1]
        stats = self.hub.stats()
        if self.stats0 is None:
            self.stats0 = stats
        for k, v in stats.items():
            self.counts[f"hub.{k}"] = v - self.stats0[k]

    def release(self) -> None:
        self.hub.close()
        del self.hub, self.end_stream

    def end_to_end(self, window_s: float, latencies) -> dict:
        ms = np.asarray(latencies) * 1e3
        batches = max(self.counts.get("hub.batches", 0), 1)
        log(f"hub: {len(ms)} shots, ms a shot median {np.median(ms)}, "
            f"min {ms.min()}, max {ms.max()}; ms a batch after the first "
            "shot: " + ", ".join(
                f"{k[4:]} {1e3 * v / batches}" for k, v in self.counts.items()
                if k.startswith("hub.") and k.endswith("_s")))
        return {"decode_mpix_s": self.pixels / window_s / 1e6,
                "bits_per_pixel": 8 * self.bytes / max(self.pixels, 1)}

    def check(self) -> dict:
        wrong = 0
        for streams in self.kept:
            for st in streams or ():
                got = np.concatenate(st.kept) if st.kept else None
                wrong += mismatch(got, self.ctx.expected(st.recording))
        return {"streams_wrong": self.streams_wrong, "pixels_wrong": wrong}

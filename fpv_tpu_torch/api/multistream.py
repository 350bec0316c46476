"""Multi-stream serving: many independent camera streams per card.

The reference binds one encoder instance to one stream and scales by adding
CPU threads.  These hubs multiplex any number of independent streams (same
frame geometry) onto a card instead: each stream keeps its own delta frame,
flags and FPVT output file, while the kernels are shared by every stream.
Both hubs take ``devices=[...]``, torch devices that streams are assigned
to round-robin.

Frames are queued per stream; full batches are encoded on a worker thread
and delivered to the sink in per-stream order:

    hub = MultiStreamEncoder(1024, 1024, shift=4, sink=write_fn)
    hub.add_stream("cam0", first_frame0)
    hub.push_frame("cam0", ts, frame)
    ...
    hub.close()          # flushes partial batches + footers

``sink(stream_id, data: bytes)`` receives ordered byte chunks forming each
stream's valid FPVT file.  A worker's error surfaces as RuntimeError from
the next ``push_frame``/``feed`` or from ``close``.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from fpv_tpu_torch.api.fpvt_codec import (
    FpvtStreamingReader,
    FpvtWriter,
    resolve_device,
)

# how long close() waits for a worker to drain before it raises
DRAIN_TIMEOUT_S = 600


def _safe_put(q: queue.Queue, item, check_error) -> None:
    """Bounded put that cannot hang on a dead worker: re-check the hub
    error between timeouts (a worker that died never drains the queue, so
    a plain blocking put would wait forever)."""
    while True:
        check_error()
        try:
            q.put(item, timeout=1.0)
            return
        except queue.Full:
            continue


def _devices(devices) -> list:
    """The hub's devices (default: the current CUDA device), each checked
    (a CUDA device needs a card)."""
    return [resolve_device(d) for d in (devices or ["cuda"])]


class MultiStreamEncoder:
    def __init__(
        self,
        xsize: int,
        ysize: int,
        shift: int = 0,
        big_endian: bool = False,
        frames_per_batch: int = 16,
        chunk_log2: int = 12,
        sink=None,
        devices=None,
    ) -> None:
        """``devices``: optional list of torch devices (default
        ``["cuda"]``); streams are assigned round-robin."""
        self._devices = _devices(devices)
        self._next_device = 0
        self._geom = (xsize, ysize, shift, big_endian, frames_per_batch,
                      chunk_log2)
        self._fpb = frames_per_batch
        self._sink = sink or (lambda sid, data: None)
        self._writers: dict[str, FpvtWriter] = {}
        self._pending: dict[str, list] = {}
        self._queue: queue.Queue = queue.Queue(maxsize=4)  # backpressure
        self._lock = threading.Lock()
        self._error: BaseException | None = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def add_stream(self, stream_id: str, delta_frame: np.ndarray) -> None:
        """Register a stream; its first/delta frame defines the prediction
        base (it is NOT emitted as a frame — push it again if it should be)."""
        if stream_id in self._writers:
            raise ValueError(f"stream {stream_id!r} already exists")
        x, y, shift, be, fpb, cl = self._geom
        dev = self._devices[self._next_device % len(self._devices)]
        self._next_device += 1
        # narrow=False: hub streams are long-lived (unbounded total size),
        # so the small-file narrow policy would cost every batch a slower
        # route for a storage saving that only small files see
        w = FpvtWriter(x, y, shift, be, fpb, cl, device=dev, narrow=False)
        header = w.init(delta_frame)
        with self._lock:
            self._writers[stream_id] = w
            self._pending[stream_id] = []
        self._sink(stream_id, header)

    def push_frame(self, stream_id: str, timestamp: int, frame: np.ndarray) -> None:
        self._check_error()
        with self._lock:
            pend = self._pending[stream_id]
            pend.append((int(timestamp), np.asarray(frame, np.uint16)))
            if len(pend) >= self._fpb:
                batch, self._pending[stream_id] = pend, []
                # enqueue INSIDE the lock: releasing it first would let a
                # concurrent producer enqueue batch k+1 before batch k,
                # breaking per-stream order.  The put cannot deadlock —
                # the worker drains the queue without taking this lock.
                _safe_put(self._queue, (stream_id, batch), self._check_error)

    def _flush_stream(self, stream_id: str) -> None:
        with self._lock:
            batch, self._pending[stream_id] = self._pending[stream_id], []
            if batch:  # inside the lock, same ordering argument as push_frame
                _safe_put(self._queue, (stream_id, batch), self._check_error)

    def close(self) -> None:
        """Flush all partial batches, emit footers, stop the worker."""
        self._check_error()
        for sid in list(self._writers):
            self._flush_stream(sid)
        _safe_put(self._queue, None, self._check_error)
        self._worker.join(timeout=DRAIN_TIMEOUT_S)
        self._check_error()
        if self._worker.is_alive():
            # emitting footers while the worker still appends batches
            # would silently corrupt every stream's file
            raise TimeoutError(
                f"encoder worker did not drain within {DRAIN_TIMEOUT_S} s")
        for sid, w in self._writers.items():
            self._sink(sid, w.finish())

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            sid, batch = item
            try:
                w = self._writers[sid]
                ts = np.array([t for t, _ in batch], np.int64)
                imgs = np.stack([f for _, f in batch])
                section = w.encode_batch_bytes(imgs, ts)
                w.add_batch(section, len(batch))
                self._sink(sid, section)
            except Exception as e:
                # Exception, not BaseException: KeyboardInterrupt/SystemExit
                # must keep interpreter-shutdown semantics, not become a
                # stored "worker failed" error
                self._error = e
                return

    def _check_error(self) -> None:
        if self._error is not None:
            raise RuntimeError("encoder worker failed") from self._error


class MultiStreamDecoder:
    """Decode-side twin of :class:`MultiStreamEncoder`: many FPVT byte
    streams multiplexed onto a card.

    Per stream, an incremental :class:`FpvtStreamingReader` consumes byte
    chunks.  Two workers pipeline the batches: the issue worker parses
    each complete batch section and queues its decode on the device
    (uploads, one K2 launch for its planes, K3 and the elementwise work,
    on the stream's reader's own CUDA stream) without waiting for it; the
    finalize worker waits for that batch alone, copies its frames to the
    host on a second stream and runs the sink.  So batch n's download
    overlaps batch n+1's upload and decode.  The sink receives
    ``sink(stream_id, frames u16 [B,H,W], timestamps i64 [B])`` (plus a
    previews u8 [B,H//4,W//4] argument when ``want_previews``) in
    per-stream order.

        hub = MultiStreamDecoder(sink=on_frames)
        hub.add_stream("cam0")
        hub.feed("cam0", chunk)     # any chunking, any interleaving
        ...
        hub.close()
    """

    def __init__(
        self, sink=None, want_previews: bool = False, devices=None,
        device_frames: bool = False, upload_cache: dict | None = None,
    ) -> None:
        """``devices``: optional list of torch devices (default
        ``["cuda"]``); streams are assigned round-robin.

        ``device_frames``: the sink receives frames and previews as device
        tensors left on the card instead of host numpy arrays (frames
        int32 [B,H,W] holding the u16 values, previews uint8), for
        consumers that run on the card themselves.

        ``upload_cache``: optional dict staging batch uploads on the device
        by content, shared across this hub's streams (and any reader given
        the same dict): feeding bytes whose batches are already staged
        skips their parse and upload (replay and multicast serving).
        Caller-owned and caller-bounded: entries hold device memory."""
        self._devices = _devices(devices)
        self._sink = sink or (lambda sid, *a: None)
        self._want_previews = want_previews
        self._device_frames = device_frames
        self._upload_cache = upload_cache
        self._next_device = 0
        self._readers: dict[str, FpvtStreamingReader] = {}
        self._queue: queue.Queue = queue.Queue(maxsize=4)  # backpressure
        # two-stage pipeline: the issue worker queues each batch's device
        # work; the finalize worker downloads and runs the sink.  maxsize
        # bounds the batches in flight on the device
        self._finq: queue.Queue = queue.Queue(maxsize=2)
        self._error: BaseException | None = None
        # start the finalizer first: the issue worker's error path
        # references self._finalizer
        self._finalizer = threading.Thread(target=self._run_fin, daemon=True)
        self._finalizer.start()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def add_stream(self, stream_id: str, content_id=None) -> None:
        """``content_id``: caller-declared identity of the stream's bytes;
        with an ``upload_cache`` it replaces per-section content hashing
        (FpvtStreamingReader ``content_id`` semantics and caveats)."""
        if stream_id in self._readers:
            raise ValueError(f"stream {stream_id!r} already exists")

        def hook(fin, ts, sid=stream_id):
            _safe_put(self._finq, (sid, fin, ts), self._check_error)

        dev = self._devices[self._next_device % len(self._devices)]
        self._next_device += 1
        self._readers[stream_id] = FpvtStreamingReader(
            lambda *a: None,
            want_previews=self._want_previews,
            batch_hook=hook,
            device=dev,
            device_frames=self._device_frames,
            upload_cache=self._upload_cache,
            content_id=content_id,
        )

    def feed(self, stream_id: str, data: bytes) -> None:
        """Queue a byte chunk for ``stream_id`` (blocks when 4 deep)."""
        self._check_error()
        if stream_id not in self._readers:
            raise KeyError(f"unknown stream {stream_id!r}")
        _safe_put(self._queue, (stream_id, bytes(data)), self._check_error)

    def close(self) -> None:
        """Drain both pipeline stages and stop the workers."""
        self._check_error()
        _safe_put(self._queue, None, self._check_error)
        self._worker.join(timeout=DRAIN_TIMEOUT_S)
        self._finalizer.join(timeout=DRAIN_TIMEOUT_S)
        self._check_error()
        if self._worker.is_alive() or self._finalizer.is_alive():
            # returning success with undelivered batches would silently
            # drop frames
            raise TimeoutError(
                f"decoder pipeline did not drain within {DRAIN_TIMEOUT_S} s")

    def _deliver_fin_sentinel(self) -> None:
        """Deliver the finalizer its shutdown sentinel without ever hanging:
        a healthy finalizer drains the queue (bounded put eventually lands)
        and a dead one stops needing it."""
        while self._finalizer.is_alive():
            try:
                self._finq.put(None, timeout=0.5)
                return
            except queue.Full:
                continue

    def _run(self) -> None:
        try:
            while True:
                item = self._queue.get()
                if item is None:
                    self._deliver_fin_sentinel()
                    return
                sid, data = item
                self._readers[sid].decode(data)
        except Exception as e:
            # Exception, not BaseException: KeyboardInterrupt/SystemExit
            # must keep interpreter-shutdown semantics, not become a
            # stored "worker failed" error
            self._error = e
            self._deliver_fin_sentinel()

    def _run_fin(self) -> None:
        while True:
            item = self._finq.get()
            if item is None:
                return
            sid, fin, ts = item
            try:
                imgs, pv = fin()
                if self._want_previews:
                    self._sink(sid, imgs, ts, pv)
                else:
                    self._sink(sid, imgs, ts)
            except Exception as e:
                self._error = e
                return

    def _check_error(self) -> None:
        if self._error is not None:
            raise RuntimeError("decoder worker failed") from self._error

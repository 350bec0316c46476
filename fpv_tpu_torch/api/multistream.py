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
the next ``push_frame``/``feed`` or from ``end_stream``/``close``.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from fpv_tpu_torch.api.fpvt_codec import (
    FpvtStreamingReader,
    FpvtWriter,
    resolve_device,
)
from fpv_tpu_torch.utils.profiling import annotate

# how long close() and end_stream() wait for the workers to drain before
# they raise
DRAIN_TIMEOUT_S = 600

# a decode hub's issue workers.  Their host copies (each chunk into its
# stream's buffer, each section's payload into pinned memory) run outside
# the interpreter lock, so a second worker copies while the first queues
# its batch's device work
ISSUE_WORKERS = 2


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


class _Inbox(queue.Queue):
    """An issue worker's input queue: a bounded FIFO whose producers,
    once they block on it full, are woken when it has drained to ``low``
    items rather than at every item taken, so that a client feeding chunk
    after chunk switches threads once every ``maxsize - low`` chunks, not
    once a chunk."""

    def __init__(self, maxsize: int, low: int) -> None:
        super().__init__(maxsize)
        self._low = low

    def get(self):
        with self.not_empty:
            while not self._qsize():
                self.not_empty.wait()
            item = self._get()
            if self._qsize() <= self._low:
                self.not_full.notify_all()
            return item


def _timed_put(q: queue.Queue, item, check_error) -> float:
    """:func:`_safe_put`, returning the seconds it blocked."""
    t0 = time.perf_counter()
    _safe_put(q, item, check_error)
    return time.perf_counter() - t0


class _End:
    """A stream's end marker: it passes through the issue queue behind the
    stream's last chunk, then through the finalize queue behind its last
    batch, where ``done`` is set.  ``complete``: the stream's footer had
    arrived; ``pending``: the bytes its reader held undecoded."""

    __slots__ = ("done", "complete", "pending")

    def __init__(self) -> None:
        self.done = threading.Event()
        self.complete = False
        self.pending = 0


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
    chunks.  Two stages pipeline the batches: an issue worker parses each
    complete batch section and queues its decode on the device (uploads,
    one K2 launch for its planes, K3 and the elementwise work, on the
    stream's reader's own CUDA stream) without waiting for it; the
    finalize worker waits for that batch alone, copies its frames to the
    host on a second stream and runs the sink.  So batch n's download
    overlaps batch n+1's upload and decode.  The streams are shared out
    among :data:`ISSUE_WORKERS` issue workers, each stream to the one
    serving the fewest when it is added: a stream's chunks all pass
    through its worker in order, and the workers' host copies run at once.
    The sink receives ``sink(stream_id, frames u16 [B,H,W], timestamps
    i64 [B])`` (plus a previews u8 [B,H//4,W//4] argument when
    ``want_previews``) in per-stream order, from the finalize worker.

        hub = MultiStreamDecoder(sink=on_frames)
        hub.add_stream("cam0")
        hub.feed("cam0", chunk)     # any chunking, any interleaving
        ...
        hub.end_stream("cam0")      # its frames delivered, its reader freed
        ...
        hub.close()

    A long-lived hub serves streams that come and go: ``end_stream``
    retires one while the others go on, and the id may be added again.

    Spans (``utils/profiling.annotate``, for traces that record every
    thread and for NVTX): ``fpvt.hub.feed`` (the client's ``feed``, its
    wait for queue room included), ``fpvt.hub.issue`` (one chunk through
    its stream's reader, on its issue worker), ``fpvt.hub.finalize``
    (``finalize`` and the sink, on the finalize worker) and
    ``fpvt.hub.end`` (``end_stream``'s wait).  :meth:`stats` reads the
    hub's cumulative counters of where its stages wait.
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
        # each issue worker's input queue (backpressure) and the streams
        # it serves: a stream's worker by id, the live streams by worker
        self._queues = [_Inbox(maxsize=8, low=2)
                        for _ in range(ISSUE_WORKERS)]
        self._route: dict[str, int] = {}
        self._served = [0] * ISSUE_WORKERS
        self._lock = threading.Lock()
        # two-stage pipeline: the issue workers queue each batch's device
        # work; the finalize worker downloads and runs the sink.  maxsize
        # bounds the batches in flight on the device
        self._finq: queue.Queue = queue.Queue(maxsize=2)
        self._error: BaseException | None = None
        self._ending: set[_End] = set()  # end_stream waits, woken on failure
        # byte buffers of retired streams' readers, for the next streams:
        # a hub serving shot after shot allocates them once
        self._spare: list[np.ndarray] = []
        # counters: feed_wait_s (any client thread; under _lock) and
        # finalize_s here, the issue workers' each in its own dict
        self._stats = dict(feed_wait_s=0.0, finalize_s=0.0)
        self._issue_stats = [dict(issue_idle_s=0.0, fin_wait_s=0.0,
                                  batches=0) for _ in range(ISSUE_WORKERS)]
        self._issuing = ISSUE_WORKERS  # the last to stop ends the finalizer
        # start the finalizer first: the issue workers' exit references it
        self._finalizer = threading.Thread(target=self._run_fin, daemon=True)
        self._finalizer.start()
        self._workers = [threading.Thread(target=self._run, args=(w,),
                                          daemon=True)
                         for w in range(ISSUE_WORKERS)]
        for t in self._workers:
            t.start()

    def add_stream(self, stream_id: str, content_id=None) -> None:
        """``content_id``: caller-declared identity of the stream's bytes;
        with an ``upload_cache`` it replaces per-section content hashing
        (FpvtStreamingReader ``content_id`` semantics and caveats)."""
        with self._lock:
            if stream_id in self._readers:
                raise ValueError(f"stream {stream_id!r} already exists")
            w = self._served.index(min(self._served))
            stats = self._issue_stats[w]

            def hook(fin, ts, sid=stream_id):
                stats["fin_wait_s"] += _timed_put(
                    self._finq, (sid, fin, ts), self._check_error)
                stats["batches"] += 1

            self._readers[stream_id] = FpvtStreamingReader(
                lambda *a: None,
                want_previews=self._want_previews,
                batch_hook=hook,
                device=self._devices[self._next_device % len(self._devices)],
                device_frames=self._device_frames,
                upload_cache=self._upload_cache,
                content_id=content_id,
                buffer=self._spare.pop() if self._spare else None,
            )
            self._next_device += 1
            self._served[w] += 1
            self._route[stream_id] = w

    def feed(self, stream_id: str, data: bytes) -> None:
        """Queue a byte chunk for ``stream_id`` (blocks when its issue
        worker has 8 queued, until it has 2).  A ``bytes`` chunk, or a memoryview of one,
        is queued as it is (it cannot change); any other buffer is copied,
        since its owner may reuse it once ``feed`` returns."""
        with annotate("fpvt.hub.feed"):
            self._check_error()
            if stream_id not in self._readers:
                raise KeyError(f"unknown stream {stream_id!r}")
            if not isinstance(getattr(data, "obj", data), bytes):
                data = bytes(data)
            self._put_input(self._route[stream_id], (stream_id, data))

    def end_stream(self, stream_id: str) -> None:
        """Retire ``stream_id``: return once every chunk fed for it has
        been issued and every one of its batches has reached the sink,
        then drop its reader (its delta planes on the device; its byte
        buffer goes to the next stream added); the id may be added again.
        The other streams go on meanwhile, each in its turn in the shared
        queues.

        Raises ValueError naming the stream when its footer never arrived,
        its bytes cut short inside a section or between two (frames are
        never dropped silently; the reader is dropped all the same), and
        RuntimeError when a worker failed."""
        self._check_error()
        if stream_id not in self._readers:
            raise KeyError(f"unknown stream {stream_id!r}")
        end = _End()
        with annotate("fpvt.hub.end"):
            self._ending.add(end)  # a failing worker sets it
            try:
                self._put_input(self._route[stream_id], (stream_id, end))
                end.done.wait(DRAIN_TIMEOUT_S)
            finally:
                self._ending.discard(end)
        self._check_error()
        if not end.done.is_set():
            raise TimeoutError(
                f"stream {stream_id!r} did not drain within "
                f"{DRAIN_TIMEOUT_S} s")
        with self._lock:
            self._spare.append(self._readers.pop(stream_id).buffer)
            self._served[self._route.pop(stream_id)] -= 1
        if not end.complete:
            raise ValueError(
                f"stream {stream_id!r} ended before its footer: "
                f"{end.pending} bytes fed were never decoded")

    def stats(self) -> dict:
        """The hub's cumulative counters, since it opened: ``feed_wait_s``
        (clients blocked on a full input queue), ``issue_idle_s`` (the
        issue workers waiting on empty ones), ``fin_wait_s`` (the issue
        workers blocked handing a batch to the full finalize queue),
        ``finalize_s`` (the finalize worker in ``finalize`` and the sink)
        and ``batches`` (batches handed to the finalize worker, each
        stream's frame 0 included); the issue workers' summed."""
        out = dict(feed_wait_s=self._stats["feed_wait_s"], issue_idle_s=0.0,
                   fin_wait_s=0.0, finalize_s=self._stats["finalize_s"],
                   batches=0)
        for st in self._issue_stats:
            for k, v in st.items():
                out[k] += v
        return out

    def _put_input(self, w: int, item) -> None:
        dt = _timed_put(self._queues[w], item, self._check_error)
        with self._lock:
            self._stats["feed_wait_s"] += dt

    def close(self) -> None:
        """Drain both pipeline stages and stop the workers."""
        self._check_error()
        for w in range(ISSUE_WORKERS):
            self._put_input(w, None)
        for t in self._workers:
            t.join(timeout=DRAIN_TIMEOUT_S)
        self._finalizer.join(timeout=DRAIN_TIMEOUT_S)
        self._check_error()
        if self._finalizer.is_alive() or any(t.is_alive()
                                             for t in self._workers):
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

    def _run(self, w: int) -> None:
        """Issue worker ``w``: its streams' chunks through their readers,
        until its queue's sentinel or any worker's failure."""
        q, stats = self._queues[w], self._issue_stats[w]
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                stats["issue_idle_s"] += time.perf_counter() - t0
                if item is None or self._error is not None:
                    return
                sid, data = item
                if isinstance(data, _End):
                    data.complete = self._readers[sid].complete
                    data.pending = self._readers[sid].pending_bytes()
                    stats["fin_wait_s"] += _timed_put(
                        self._finq, (sid, data, None), self._check_error)
                    continue
                with annotate("fpvt.hub.issue"):
                    self._readers[sid].decode(data)
        except Exception as e:
            # Exception, not BaseException: KeyboardInterrupt/SystemExit
            # must keep interpreter-shutdown semantics, not become a
            # stored "worker failed" error
            self._fail(e)
        finally:
            with self._lock:
                self._issuing -= 1
                last = self._issuing == 0
            if last:  # no worker hands the finalizer a batch any more
                self._deliver_fin_sentinel()

    def _run_fin(self) -> None:
        while True:
            item = self._finq.get()
            if item is None:
                return
            sid, fin, ts = item
            if isinstance(fin, _End):
                fin.done.set()  # the stream's batches all reached the sink
                continue
            t0 = time.perf_counter()
            try:
                with annotate("fpvt.hub.finalize"):
                    imgs, pv = fin()
                    if self._want_previews:
                        self._sink(sid, imgs, ts, pv)
                    else:
                        self._sink(sid, imgs, ts)
            except Exception as e:
                self._fail(e)
                return
            self._stats["finalize_s"] += time.perf_counter() - t0

    def _fail(self, e: Exception) -> None:
        """Keep a worker's first error, wake every ``end_stream`` and stop
        the issue workers: each leaves at its next item, and one whose
        queue has room gets a sentinel to wake it."""
        if self._error is None:
            self._error = e
        for end in list(self._ending):
            end.done.set()
        for q in self._queues:
            try:
                q.put_nowait(None)
            except queue.Full:
                pass

    def _check_error(self) -> None:
        if self._error is not None:
            raise RuntimeError("decoder worker failed") from self._error

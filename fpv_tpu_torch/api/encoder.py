"""Session-layer FPV1 encoder with the reference's Encoder semantics.

Mirrors ``fpvc::Encoder`` (fusion_power_video.h:175-255): ``init`` writes
the header + compressed delta-frame chunk, ``compress_frame`` queues one
frame and invokes its callback *in submission order* when the compressed
chunk is ready, ``finish`` drains everything and writes the frame-index
footer.  Bytes equal the JAX package's ``Encoder``.

The filter chain (split, preview, decision histograms, delta and CG
residuals) runs on the device on the calling thread, which makes the
frame's copy at submission; the predicted planes come back to the host in
one download and their brotli streams are compressed on a thread pool.
Ordering is enforced like the reference's cv_out barrier
(fusion_power_video.cc:1199-1230), and backpressure matches
``MaxQueued() == threads + (threads+1)/2`` (fusion_power_video.cc:1171-1177).
"""

from __future__ import annotations

import collections
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from fpv_tpu_torch.api import frame as frame_ops
from fpv_tpu_torch.api.fpvt_codec import resolve_device
from fpv_tpu_torch.api.frame import FrameFlags, FramePlanes
from fpv_tpu_torch.format import container
from fpv_tpu_torch.ops.planes import resolve_u8_shift, validate_u8_config

Callback = Callable[[bytes, object], None]

ENCODE_BATCH = 16  # frames per device step in encode_file


def _host(tensors: list) -> list:
    """Host copies of device tensors (None stays None), downloaded through
    pinned memory after the current stream's work; CPU tensors as they
    are."""
    live = [t for t in tensors if t is not None]
    if not live or live[0].device.type == "cpu":
        return [None if t is None else t.numpy() for t in tensors]
    host = [None if t is None else t.to("cpu", non_blocking=True)
            for t in tensors]
    torch.cuda.current_stream(live[0].device).synchronize()
    return [None if t is None else t.numpy() for t in host]


def _predicted_frames(p: FramePlanes) -> list[tuple]:
    """A predicted batch -> per frame (flags, high, low, preview) host
    arrays, in one download (the low planes only if a frame stores one)."""
    store_low = any(not f & FrameFlags.NO_LOW_BYTES for f in p.flags)
    high, low, preview = (
        None if a is None else np.ascontiguousarray(a)
        for a in _host([p.high, p.low if store_low else None, p.preview]))
    return [(f, high[i], None if low is None else low[i],
             None if preview is None else preview[i])
            for i, f in enumerate(p.flags)]


def _frame_chunk(item: tuple) -> bytes:
    """One predicted frame -> frame chunk bytes (runs on a pool thread)."""
    flags, high, low, preview = item
    image_bs = container.serialize_image(flags, high, low)
    preview_bs = container.serialize_preview_image(preview, flags)
    return container.serialize_frame_chunk(preview_bs, image_bs)


class Encoder:
    """Streaming encoder producing reference-format (FPV1) files.

    Parameters mirror the reference ctor (fusion_power_video.h:179):
    ``num_threads`` sizes the brotli pool (0 = synchronous), ``shift`` is
    the left-align shift for sub-16-bit data, ``big_endian`` the raw input
    endianness.  The filter chain runs on ``device`` (default the card;
    without one this raises)."""

    def __init__(self, num_threads: int = 8, shift: int = 0,
                 big_endian: bool = False, device="cuda") -> None:
        self._device = resolve_device(device)
        self._num_threads = int(num_threads)
        self._shift = int(shift)
        self._big_endian = bool(big_endian)
        self._pool = (ThreadPoolExecutor(max_workers=self._num_threads)
                      if self._num_threads else None)
        self._pending: collections.deque[tuple[Future | bytes, Callback, object]] = (
            collections.deque())
        self._delta: FramePlanes | None = None
        self._xsize = 0
        self._ysize = 0
        self._frame_offsets: list[int] = []
        self._bytes_written = 0
        self._finished = False

    def max_queued(self) -> int:
        """Max frames in flight (fusion_power_video.cc:1171-1177)."""
        if not self._num_threads:
            return 1
        return self._num_threads + (self._num_threads + 1) // 2

    def _upload(self, imgs: np.ndarray) -> torch.Tensor:
        """[B, H, W] frames -> a copy on the device: uint8 frames (Frame's
        8-bit ctor, fusion_power_video.cc:453-465; a shift-8
        little-endian stream only) as uint8, others as int32 u16
        samples."""
        imgs = np.asarray(imgs)
        if imgs.dtype == np.uint8:
            validate_u8_config(self._shift, self._big_endian)
            return self._copy_to_device(imgs)
        imgs = imgs.astype(np.uint16, copy=False).view(np.int16)
        return self._copy_to_device(imgs).to(torch.int32) & 0xFFFF

    def _copy_to_device(self, a: np.ndarray) -> torch.Tensor:
        """A copy of the host array on the device (through pinned memory
        to a card, without waiting for it)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.clone()

    def _upload_planes(self, high, low) -> FramePlanes:
        """[B, H, W] byte planes -> a copy on the device, adopted."""
        high = np.ascontiguousarray(high, dtype=np.uint8)
        if high.shape[1:] != (self._ysize, self._xsize):
            raise ValueError("high plane must be [ysize, xsize] uint8")
        if low is not None:
            low = np.ascontiguousarray(low, dtype=np.uint8)
            if low.shape != high.shape:
                raise ValueError("low plane shape must match high plane")
        return frame_ops.adopt_planes(
            *(None if a is None else self._copy_to_device(a)
              for a in (high, low)))

    def _init_core(self, planes: FramePlanes, callback: Callback,
                   payload: object) -> None:
        """Header + delta-frame chunk (Encoder::Init,
        fusion_power_video.cc:1086-1106).  The reference generates and
        CG-codes a preview of the delta frame, but OutputCore never emits
        it, so none is made; the CG decision only looks at the high plane."""
        self._delta = FramePlanes(high=planes.high[0], low=planes.low[0])
        flags, high, low, _pv = _predicted_frames(
            frame_ops.predict(planes, None, make_preview=False))[0]
        out = (container.serialize_header(self._xsize, self._ysize)
               + container.serialize_delta_chunk(
                   container.serialize_image(flags, high, low)))
        self._bytes_written = len(out)
        callback(out, payload)

    def init(self, delta_frame: np.ndarray, xsize: int, ysize: int,
             callback: Callback, payload: object = None) -> None:
        """Write header + delta-frame chunk."""
        self._xsize, self._ysize = int(xsize), int(ysize)
        imgs = self._upload(np.asarray(delta_frame).reshape(1, ysize, xsize))
        self._init_core(
            frame_ops.split_planes(imgs, self._shift, self._big_endian),
            callback, payload)

    def init_planes(self, high: np.ndarray, low: np.ndarray | None,
                    callback: Callback, payload: object = None) -> None:
        """Plane-adopting twin of :meth:`init`: the delta frame enters as
        pre-split [H, W] byte planes (fusion_power_video.cc:467-489)."""
        self._ysize, self._xsize = np.shape(high)
        planes = self._upload_planes(
            np.asarray(high)[None], None if low is None else np.asarray(low)[None])
        self._init_core(planes, callback, payload)

    def _queue(self, planes: FramePlanes, callbacks) -> None:
        """Predict a batch on the device, then queue each frame's brotli
        streams; callbacks fire in order, at most ``max_queued()`` frames
        in flight."""
        items = _predicted_frames(frame_ops.predict(planes, self._delta))
        for item, (callback, payload) in zip(items, callbacks):
            if self._pool is None:
                self._pending.append((_frame_chunk(item), callback, payload))
            else:
                self._pending.append(
                    (self._pool.submit(_frame_chunk, item), callback, payload))
            # emit every completed head-of-queue task, then block on the
            # head until under the limit (the cv_main wait,
            # fusion_power_video.cc:1150-1156)
            self._drain(block=False)
            while len(self._pending) >= self.max_queued():
                self._drain_one()

    def compress_frame(self, img: np.ndarray, callback: Callback,
                       payload: object = None) -> None:
        """Queue one frame; callbacks fire in submission order.  ``img``
        is copied at submission, so the caller may reuse its buffer."""
        if self._delta is None:
            raise RuntimeError("init() must be called first")
        self._compress_batch(np.asarray(img)[None], [(callback, payload)])

    def _compress_batch(self, imgs, callbacks) -> None:
        """[B, H, W] frames through one device step, queued in order:
        host frames, or int32 u16 samples already on the encoder's
        device (the transcoder's decoded batches)."""
        if not isinstance(imgs, torch.Tensor):
            imgs = self._upload(
                np.asarray(imgs).reshape(-1, self._ysize, self._xsize))
        self._queue(
            frame_ops.split_planes(imgs, self._shift, self._big_endian),
            callbacks)

    def compress_frame_planes(self, high: np.ndarray, low: np.ndarray | None,
                              callback: Callback,
                              payload: object = None) -> None:
        """Queue one frame given as pre-split byte planes; ``low=None`` (or
        an all-zero low) makes a NO_LOW_BYTES frame.  Output bytes equal
        :meth:`compress_frame` on the combined image."""
        if self._delta is None:
            raise RuntimeError("init() must be called first")
        planes = self._upload_planes(
            np.asarray(high)[None], None if low is None else np.asarray(low)[None])
        self._queue(planes, [(callback, payload)])

    def _drain_one(self) -> None:
        task, callback, payload = self._pending.popleft()
        data = task.result() if isinstance(task, Future) else task
        self._frame_offsets.append(self._bytes_written)
        self._bytes_written += len(data)
        callback(data, payload)

    def _drain(self, block: bool) -> None:
        while self._pending:
            head = self._pending[0][0]
            if not block and isinstance(head, Future) and not head.done():
                return
            self._drain_one()

    def finish(self, callback: Callback, payload: object = None) -> None:
        """Drain all queued frames and emit the footer (Encoder::Finish)."""
        if self._finished:
            return
        self._finished = True
        self._drain(block=True)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        callback(container.serialize_footer(self._frame_offsets), payload)


def encode_file(frames: np.ndarray, shift: int = 0, big_endian: bool = False,
                num_threads: int = 4, delta_frame: np.ndarray | None = None,
                device="cuda") -> bytes:
    """One-shot encode of [N, H, W] uint16 frames -> FPV1 bytes, the
    ``Encoder``'s bytes.  uint8 frames are accepted directly (shift
    auto-selects 8, the reference's 8-bit Frame ctor layout).  The device
    step runs over ``ENCODE_BATCH`` frames at a time."""
    frames = np.asarray(frames)
    shift = resolve_u8_shift(frames.dtype, shift, big_endian)
    if frames.ndim != 3:
        raise ValueError("frames must be [N, H, W]")
    if delta_frame is None:
        delta_frame = frames[0]
    n, ysize, xsize = frames.shape
    chunks: list[bytes] = []

    def cb(data: bytes, _payload: object) -> None:
        chunks.append(data)

    enc = Encoder(num_threads=num_threads, shift=shift,
                  big_endian=big_endian, device=device)
    enc.init(delta_frame, xsize, ysize, cb)
    for s in range(0, n, ENCODE_BATCH):
        part = frames[s : s + ENCODE_BATCH]
        enc._compress_batch(part, [(cb, None)] * len(part))
    enc.finish(cb)
    return b"".join(chunks)

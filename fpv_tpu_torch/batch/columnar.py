"""Columnar multi-frame batch subsystem, with the filter chain on the device.

Rebuild of the reference's ``columnar_batch/`` (columnar_batch.h:7-105,
columnar_batch_encoder.h:13-60, columnar_batch_decoder.h:12-58):
compressed frames accumulate into a single 64-byte-aligned backing buffer
as parallel arrays (timestamps, flags, per-plane offset tables,
concatenated plane payloads), with async encode/decode pipelines exposing
futures.  The arrays and payloads equal the JAX package's
``fpv_tpu.batch.columnar``.

Deliberate fixes over the reference (documented defects, SURVEY.md 2.2):

* ``BatchSchema`` actually stores the compressed delta planes (the
  reference passed zero-length buffers to CompressPredicted,
  columnar_batch.cc:10-23);
* the decoder reconstructs the delta frame from (high, low) (the reference
  passed the high plane twice, columnar_batch_decoder.cc:70-77);
* queue flags are protected by locks (the reference read ``closing_``
  unlocked, columnar_batch_encoder.cc:27).

On the device: each pushed frame's split and prediction run through the
batched ``api/frame.py`` as a batch of one on the encoder's device (the
card by default), with one download of its predicted planes; brotli runs
on the host.  ``ColumnarBatchDecoder`` extracts a whole batch as one
device batch: brotli into one host batch, one upload, one K4 launch for
the batch's CG frames (or CG previews), the delta add, one download.
"""

from __future__ import annotations

import dataclasses
import enum
import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from fpv_tpu_torch.api import frame as frame_ops
from fpv_tpu_torch.api.encoder import _predicted_frames
from fpv_tpu_torch.api.fpvt_codec import resolve_device
from fpv_tpu_torch.api.frame import FrameFlags, FramePlanes
from fpv_tpu_torch.entropy import brotli
from fpv_tpu_torch.format.container import _host_batch
from fpv_tpu_torch.models import predictors
from fpv_tpu_torch.ops.planes import to_int16, validate_u8_config


def _align64(n: int) -> int:
    return (n + 63) & ~63


class ImageType(enum.Enum):
    PREVIEW = 0
    MSB8 = 1
    FULL = 2


@dataclasses.dataclass
class Image:
    """Decoded output record (columnar_batch.h:35-65)."""

    timestamp: int = -1
    xsize: int = 0
    ysize: int = 0
    bpp: int = 0
    type: ImageType = ImageType.FULL
    data: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint8)
    )

    def data8(self) -> np.ndarray:
        return self.data.view(np.uint8)

    def data16(self) -> np.ndarray:
        return self.data.view(np.uint16)


def _upload_frame(img: np.ndarray, device: torch.device) -> torch.Tensor:
    """One uint16 [H, W] host frame -> int32 [1, H, W] u16 samples on
    ``device`` (a copy)."""
    t = torch.from_numpy(np.ascontiguousarray(img).view(np.int16)[None])
    return t.to(device, copy=True).to(torch.int32) & 0xFFFF


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class BatchSchema:
    """Per-stream schema: dims, shift, delta frame + its compressed planes.

    ``delta_planes`` are the delta frame's split planes on the device
    ([H, W] uint8 tensors).  The compressed copies are NOT CG-predicted
    (so any consumer can decode them with a plain brotli pass), matching
    the reference's intent (columnar_batch.h:17-19).  A shift-8 split has
    no low plane (fusion_power_video.cc:399-403, 429-433), so the schema
    then stores none."""

    def __init__(
        self,
        xsize: int,
        ysize: int,
        shifted_left: int,
        delta_planes: FramePlanes,
    ) -> None:
        self._xsize = xsize
        self._ysize = ysize
        self._shifted_left = shifted_left
        self._delta = delta_planes
        self.compressed_delta_high = brotli.compress(_host(delta_planes.high))
        if shifted_left != 8:
            self.compressed_delta_low = brotli.compress(
                _host(delta_planes.low))
        else:
            self.compressed_delta_low = b""

    @property
    def xsize(self) -> int:
        return self._xsize

    @property
    def ysize(self) -> int:
        return self._ysize

    @property
    def shifted_left(self) -> int:
        return self._shifted_left

    @property
    def delta_frame(self) -> FramePlanes:
        return self._delta


@dataclasses.dataclass
class _CompressedFrame:
    flags: int
    timestamp: int
    high: bytes
    low: bytes
    preview: bytes


def _cg_inverse(planes: torch.Tensor, cg: list[bool]) -> torch.Tensor:
    """The flat CG inverse of the ``cg`` planes of a [k, H, W] uint8 batch,
    in one K4 launch (on a card)."""
    if not any(cg) or not planes.numel():
        return planes
    if all(cg):
        return predictors.cg_flat_decode(planes)
    idx = torch.tensor([i for i, c in enumerate(cg) if c],
                       device=planes.device)
    return planes.index_copy(0, idx, predictors.cg_flat_decode(planes[idx]))


def _decode_planes(streams, size: int, device) -> torch.Tensor:
    """Brotli streams decoded into one host batch, uploaded -> uint8
    [k, size] on ``device``; a None stream (a plane not stored) gives
    zeros.  A stream that does not decode to ``size`` bytes raises
    ValueError."""
    host = _host_batch(len(streams), size, device)
    rows = host.numpy()
    for row, stream in zip(rows, streams):
        if stream is None:
            row[:] = 0
            continue
        n, _end = brotli.decompress_into(stream, 0, row)
        if n != size:
            raise ValueError("wrong decompressed plane size")
    return host.to(device, non_blocking=True)


def _add_where(mask: list[bool], planes: torch.Tensor,
               delta: torch.Tensor) -> torch.Tensor:
    """``planes + delta`` (mod 256) for the frames in ``mask``."""
    if not any(mask):
        return planes
    m = torch.tensor(mask, dtype=torch.bool, device=planes.device)
    return torch.where(m[:, None, None], planes + delta, planes)


class Batch:
    """Columnar container of up to ``batch_size`` compressed frames.

    One 64-byte-aligned backing buffer holds parallel arrays (timestamps,
    flags, offset tables) and three concatenated payload regions, mirroring
    the reference arena (columnar_batch.cc:31-56) so a whole batch can move
    as one contiguous allocation.
    """

    def __init__(self, batch_size: int, schema: BatchSchema) -> None:
        self._schema = schema
        self._batch_size = batch_size
        self._length = 0
        numpix = schema.xsize * schema.ysize
        # The reference sizes each payload region at ONE frame's worst-case
        # compressed size for the whole batch (columnar_batch.cc:33-38),
        # relying on compression to keep totals under it.  We start with the
        # same footprint but grow the arena if a batch ever overflows.
        self._previews_capacity = _align64(
            brotli.max_compressed_size(numpix // 16)
        )
        self._plane_capacity = _align64(brotli.max_compressed_size(numpix))
        self._build_arena()

    def _build_arena(self) -> None:
        batch_size = self._batch_size
        ts_cap = _align64(batch_size * 8)
        fl_cap = _align64(batch_size)
        off_cap = _align64((batch_size + 1) * 4)
        total = (
            ts_cap + fl_cap + 3 * off_cap + self._previews_capacity
            + 2 * self._plane_capacity
        )
        self._buffer = np.zeros(total, dtype=np.uint8)
        pos = 0
        self._timestamps = self._buffer[pos : pos + ts_cap].view(np.int64)
        pos += ts_cap
        self._flags = self._buffer[pos : pos + fl_cap]
        pos += fl_cap
        self._preview_offsets = self._buffer[pos : pos + off_cap].view(np.uint32)
        pos += off_cap
        self._high_offsets = self._buffer[pos : pos + off_cap].view(np.uint32)
        pos += off_cap
        self._low_offsets = self._buffer[pos : pos + off_cap].view(np.uint32)
        pos += off_cap
        self._preview = self._buffer[pos : pos + self._previews_capacity]
        pos += self._previews_capacity
        self._high = self._buffer[pos : pos + self._plane_capacity]
        pos += self._plane_capacity
        self._low = self._buffer[pos : pos + self._plane_capacity]

    def _grow(self, preview_need: int, plane_need: int) -> None:
        """Reallocate the arena, preserving appended content."""
        saved = (
            self._length,
            self._timestamps.copy(),
            self._flags.copy(),
            self._preview_offsets.copy(),
            self._high_offsets.copy(),
            self._low_offsets.copy(),
            self._preview.copy(),
            self._high.copy(),
            self._low.copy(),
        )
        while self._previews_capacity < preview_need:
            self._previews_capacity *= 2
        while self._plane_capacity < plane_need:
            self._plane_capacity *= 2
        self._build_arena()
        (self._length, ts, fl, po, ho, lo, pv, hi, lw) = saved
        self._timestamps[: len(ts)] = ts
        self._flags[: len(fl)] = fl
        self._preview_offsets[: len(po)] = po
        self._high_offsets[: len(ho)] = ho
        self._low_offsets[: len(lo)] = lo
        self._preview[: len(pv)] = pv
        self._high[: len(hi)] = hi
        self._low[: len(lw)] = lw

    @property
    def schema(self) -> BatchSchema:
        return self._schema

    @property
    def length(self) -> int:
        return self._length

    def empty(self) -> bool:
        return self._length == 0

    def full(self) -> bool:
        return self._length == self._batch_size

    def latest_timestamp(self) -> int:
        return -1 if self._length == 0 else int(self._timestamps[self._length - 1])

    def reset(self) -> None:
        self._length = 0
        self._preview_offsets[:2] = 0
        self._high_offsets[:2] = 0
        self._low_offsets[:2] = 0

    def append_compressed(self, cf: _CompressedFrame) -> bool:
        """Append one already-compressed frame (Batch::AppendPredicted)."""
        if self._length >= self._batch_size:
            return False
        i = self._length
        pv_need = int(self._preview_offsets[i]) + len(cf.preview)
        plane_need = max(
            int(self._high_offsets[i]) + len(cf.high),
            int(self._low_offsets[i]) + len(cf.low),
        )
        if pv_need > self._previews_capacity or plane_need > self._plane_capacity:
            self._grow(pv_need, plane_need)
        self._timestamps[i] = cf.timestamp
        self._flags[i] = cf.flags
        for data, region, offsets in (
            (cf.preview, self._preview, self._preview_offsets),
            (cf.high, self._high, self._high_offsets),
            (cf.low, self._low, self._low_offsets),
        ):
            start = int(offsets[i])
            region[start : start + len(data)] = np.frombuffer(data, np.uint8)
            offsets[i + 1] = start + len(data)
        self._length += 1
        return True

    @staticmethod
    def _streams(indices, region, offsets, take=None) -> list:
        """Frames ``indices``' streams in ``region`` (None where ``take``
        is False)."""
        return [region[int(offsets[i]) : int(offsets[i + 1])]
                if take is None or take[j] else None
                for j, i in enumerate(indices)]

    def extract_images(self, type: ImageType, device=None) -> list[Image]:
        """Reconstitute every frame as one device batch on ``device``
        (default: the schema's delta planes' device)."""
        return self._extract(range(self._length), type, device)

    def extract_image(self, index: int, type: ImageType) -> Image:
        """Reconstitute one frame from its slices (Batch::ExtractImage)."""
        if index >= self._length:
            raise IndexError(index)
        return self._extract([index], type, None)[0]

    def _extract(self, indices, type: ImageType, device) -> list[Image]:
        """Frames ``indices`` -> Images: the CG frames' planes inverted in
        one K4 launch, then the delta frame added to the USE_DELTA frames'
        high planes and (FULL) their stored low planes.  A NO_LOW_BYTES
        frame's low plane is zeros, without the delta frame's."""
        schema = self._schema
        delta = schema.delta_frame
        dev = delta.high.device if device is None else torch.device(device)
        xsize, ysize = schema.xsize, schema.ysize
        flags = [int(self._flags[i]) for i in indices]
        ts = [int(self._timestamps[i]) for i in indices]
        k = len(indices)
        cg = [bool(f & FrameFlags.USE_CG) for f in flags]
        if type == ImageType.PREVIEW:
            pw, ph = xsize // 4, ysize // 4
            pv = _decode_planes(self._streams(indices, self._preview,
                                              self._preview_offsets),
                                pw * ph, dev).reshape(k, ph, pw)
            pv = _host(_cg_inverse(pv, cg))
            return [Image(t, pw, ph, 8, type, p.reshape(-1).copy())
                    for t, p in zip(ts, pv)]
        high = _decode_planes(
            self._streams(indices, self._high, self._high_offsets),
            xsize * ysize, dev).reshape(k, ysize, xsize)
        high = _cg_inverse(high, cg)
        use_delta = [bool(f & FrameFlags.USE_DELTA) for f in flags]
        high = _add_where(use_delta, high, delta.high.to(dev))
        if type == ImageType.MSB8:
            return [Image(t, xsize, ysize, 8, type, p.reshape(-1).copy())
                    for t, p in zip(ts, _host(high))]
        has_low = [not f & FrameFlags.NO_LOW_BYTES for f in flags]
        low = _decode_planes(
            self._streams(indices, self._low, self._low_offsets, has_low),
            xsize * ysize, dev).reshape(k, ysize, xsize)
        low = _add_where([d and h for d, h in zip(use_delta, has_low)], low,
                         delta.low.to(dev))
        img16 = _host(to_int16(frame_ops.combine_planes(high, low)))
        bpp = 16 - schema.shifted_left
        return [Image(t, xsize, ysize, bpp, type,
                      p.view(np.uint16).reshape(-1).view(np.uint8).copy())
                for t, p in zip(ts, img16)]


def _compress_predicted(item: tuple) -> _CompressedFrame:
    """One predicted frame (flags, high, low, preview, timestamp) -> brotli
    plane streams (CompressPredicted analog)."""
    flags, high, low, preview, timestamp = item
    return _CompressedFrame(
        flags=int(flags),
        timestamp=timestamp,
        high=brotli.compress(high),
        low=(b"" if flags & FrameFlags.NO_LOW_BYTES or low is None
             else brotli.compress(low)),
        preview=brotli.compress(preview) if preview is not None else b"",
    )


class ColumnarBatchEncoder:
    """Async pipeline: push_frame -> split -> predict -> batch -> callback.

    Mirrors the reference's three-stage pipeline
    (columnar_batch_encoder.cc:24-121): ``push_frame`` returns a future that
    resolves (to ``info``) once the caller's buffer has been consumed; a
    single serializer thread appends predicted frames to the current batch in
    submission order and flushes full batches to ``batch_processor``.  The
    split and prediction of each frame run on ``device`` (default the
    card; without one this raises) on the worker pool.
    """

    def __init__(
        self,
        xsize: int,
        ysize: int,
        shift_to_left_align: int,
        big_endian: bool,
        batch_processor,
        frames_per_batch: int = 10,
        num_workers: int = 2,
        device="cuda",
    ) -> None:
        self._device = resolve_device(device)
        self._xsize = xsize
        self._ysize = ysize
        self._shift = shift_to_left_align
        self._big_endian = big_endian
        self._batch_processor = batch_processor
        self._frames_per_batch = frames_per_batch
        self._pool = ThreadPoolExecutor(max_workers=num_workers)
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._closing = False
        self._closing_future: Future = Future()
        self._delta: FramePlanes | None = None
        self._schema: BatchSchema | None = None
        self._schema_ready = threading.Event()
        self._current: Batch | None = None
        self._empty_batches: list[Batch] = []
        self._latest_ts = -1
        self._thread = threading.Thread(target=self._encoder_task, daemon=True)
        self._thread.start()

    def _split(self, img: np.ndarray) -> FramePlanes:
        return frame_ops.split_planes(_upload_frame(img, self._device),
                                      self._shift, self._big_endian)

    def push_frame(self, timestamp: int, img: np.ndarray, info=None) -> Future:
        with self._lock:
            if self._closing:
                f: Future = Future()
                f.set_exception(RuntimeError("encoder closing"))
                return f
        if np.asarray(img).dtype == np.uint8:
            # 8-bit direct input (Frame's uint8 ctor,
            # fusion_power_video.cc:453-465): widen (value-preserving; the
            # shift==8 LE split stores the sample bytes as the high plane)
            validate_u8_config(self._shift, self._big_endian)
        img = np.asarray(img, dtype=np.uint16).reshape(self._ysize, self._xsize)
        if self._delta is None:
            # first frame doubles as the delta frame; handled synchronously
            planes = self._split(img)
            self._delta = FramePlanes(high=planes.high[0], low=planes.low[0])
            self._pool.submit(self._prepare_schema)
            self._queue.put(self._pool.submit(self._predict, planes, timestamp))
            done: Future = Future()
            done.set_result(info)
            return done
        img = img.copy()
        fut_frame: Future = Future()
        self._queue.put(fut_frame)
        done = Future()

        def work():
            try:
                planes = self._split(img)
            except Exception as e:
                done.set_exception(e)
                fut_frame.set_exception(e)
                return
            done.set_result(info)  # caller buffer consumed
            try:
                fut_frame.set_result(self._predict(planes, timestamp))
            except Exception as e:
                fut_frame.set_exception(e)

        self._pool.submit(work)
        return done

    def _predict(self, planes: FramePlanes, timestamp: int) -> tuple:
        """Predict one split frame on the device -> (flags, high, low,
        preview, timestamp) on the host, in one download."""
        (item,) = _predicted_frames(frame_ops.predict(planes, self._delta))
        return (*item, timestamp)

    def _prepare_schema(self) -> None:
        self._schema = BatchSchema(
            self._xsize, self._ysize, self._shift, self._delta
        )
        self._schema_ready.set()

    def close(self) -> Future:
        with self._lock:
            if not self._closing:
                self._closing = True
                self._queue.put(None)  # sentinel
        return self._closing_future

    def return_processed_batch(self, batch: Batch) -> None:
        batch.reset()
        with self._lock:
            self._empty_batches.append(batch)

    def _batch_to_fill(self) -> Batch:
        if self._current is None:
            with self._lock:
                if self._empty_batches:
                    self._current = self._empty_batches.pop(0)
            if self._current is None:
                self._schema_ready.wait()
                self._current = Batch(self._frames_per_batch, self._schema)
        return self._current

    def _flush(self) -> None:
        if self._current is None or self._current.empty():
            self._pool.submit(self._batch_processor, None)
            return
        self._latest_ts = self._current.latest_timestamp()
        batch, self._current = self._current, None
        self._pool.submit(self._batch_processor, batch)

    def _encoder_task(self) -> None:
        try:
            while True:
                item = self._queue.get()
                if item is None:
                    self._flush()
                    self._closing_future.set_result(self._latest_ts)
                    return
                predicted = item.result() if isinstance(item, Future) else item
                batch = self._batch_to_fill()
                batch.append_compressed(_compress_predicted(predicted))
                if batch.full():
                    self._flush()
        except Exception as e:
            # a failed split/predict future must surface through
            # close()/join(), not silently kill the serializer thread
            self._closing_future.set_exception(e)

    def join(self) -> None:
        self.close().result()
        self._thread.join(timeout=60)
        self._pool.shutdown(wait=True)


class ColumnarBatchDecoder:
    """Mirror pipeline: push_batch -> future; images via callback.

    Matches ColumnarBatchDecoder (columnar_batch_decoder.cc): a single
    decoder thread extracts every image of each batch, as one device batch
    on ``device`` (default the card; without one this raises), optionally
    un-shifting left-aligned samples, and passes them to
    ``image_processor``; the future returned by ``push_batch`` resolves to
    the batch when fully extracted.  Batches from a different schema than
    the first are rejected.
    """

    def __init__(self, type: ImageType, unshift: bool, image_processor,
                 device="cuda") -> None:
        self._device = resolve_device(device)
        self._type = type
        self._unshift = unshift
        self._image_processor = image_processor
        self._queue: queue.Queue = queue.Queue()
        self._closing = False
        self._lock = threading.Lock()
        self._schema: BatchSchema | None = None
        self._latest_ts = -1
        self._closing_future: Future = Future()
        self._thread = threading.Thread(target=self._decoder_task, daemon=True)
        self._thread.start()

    def push_batch(self, batch: Batch) -> Future:
        with self._lock:
            if self._schema is None:
                self._schema = batch.schema
            if self._closing or batch.schema is not self._schema:
                f: Future = Future()
                f.set_exception(ValueError("decoder closing or foreign schema"))
                return f
        fut: Future = Future()
        self._queue.put((batch, fut))
        return fut

    def close(self) -> Future:
        with self._lock:
            if not self._closing:
                self._closing = True
                self._queue.put(None)
        return self._closing_future

    def _decoder_task(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._closing_future.set_result(self._latest_ts)
                return
            batch, fut = item
            try:
                shifted = batch.schema.shifted_left
                for img in batch.extract_images(self._type, self._device):
                    if self._unshift and shifted > 0 and img.bpp > 8:
                        d16 = img.data16()
                        d16 >>= shifted
                    self._image_processor(img)
                self._latest_ts = batch.latest_timestamp()
                fut.set_result(batch)
            except Exception as e:
                fut.set_exception(e)

    def join(self) -> None:
        self.close().result()
        self._thread.join(timeout=60)

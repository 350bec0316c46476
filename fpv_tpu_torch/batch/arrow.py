"""Apache Arrow frontend: frames -> arrow.RecordBatch stream, on the device.

Rebuild of the reference's optional ``arrow/arrow_encoder.{h,cc}``: the
same split -> predict -> compress pipeline as the columnar subsystem, but
each flushed batch is an ``arrow.RecordBatch`` with columns

    timestamp (ns) | deltaPredicted | cgPredicted | preview |
    highBytePlane | lowBytePlane          (binary, brotli plane streams)

and schema metadata carrying xsize / ysize / shiftedLeft plus the
compressed delta-frame planes (arrow/arrow_encoder.cc:81-94), so a
RecordBatch stream is fully self-describing.  Binary columns build
zero-copy, like the reference's MutableBinaryBuilder
(arrow/arrow_encoder.h:59-108): frames brotli-compress straight into a
preallocated resizable Arrow buffer and flush wraps the buffers into a
BinaryArray without copying.  The columns and metadata equal the JAX
package's ``fpv_tpu.batch.arrow``.

Each frame's split and prediction run on the encoder's device (the card
by default); :func:`decode_record_batch` inverts a whole RecordBatch as
one device batch, the delta frame's CG inverse and the rows' in one K4
launch.

Requires pyarrow; importing this module without it raises ImportError.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pyarrow as pa

from fpv_tpu_torch.api import frame as frame_ops
from fpv_tpu_torch.api.encoder import _predicted_frames
from fpv_tpu_torch.api.fpvt_codec import resolve_device
from fpv_tpu_torch.api.frame import FrameFlags, FramePlanes
from fpv_tpu_torch.batch.columnar import (
    _add_where,
    _cg_inverse,
    _decode_planes,
    _host,
    _upload_frame,
)
from fpv_tpu_torch.entropy import brotli
from fpv_tpu_torch.ops.planes import to_int16, validate_u8_config


class MutableBinaryBuilder:
    """Zero-copy Arrow BinaryArray builder.

    The role of the reference's ``MutableBinaryBuilder``
    (arrow/arrow_encoder.h:59-108): ``next_item`` hands the producer a
    writable window of the preallocated resizable data buffer (growing it
    when needed), ``advance`` commits the bytes actually written and bumps
    the offsets array, and ``finish`` assembles the BinaryArray from the
    (offsets, data) buffers without copying the payload."""

    def __init__(self, capacity: int = 1 << 20) -> None:
        self._buf = pa.allocate_buffer(capacity, resizable=True)
        self._size = 0
        self._offsets = [0]

    def next_item(self, max_size: int) -> memoryview:
        if self._size + max_size > self._buf.size:
            self._buf.resize(max(self._size + max_size, 2 * self._buf.size))
        return memoryview(self._buf)[self._size : self._size + max_size]

    def advance(self, nbytes: int) -> None:
        self._size += nbytes
        self._offsets.append(self._size)

    def append_empty(self) -> None:
        self._offsets.append(self._size)

    def finish(self) -> pa.Array:
        n = len(self._offsets) - 1
        offsets = pa.py_buffer(np.asarray(self._offsets, np.int32))
        data = pa.py_buffer(memoryview(self._buf)[: self._size])
        arr = pa.Array.from_buffers(pa.binary(), n, [None, offsets, data])
        # the emitted array aliases the old buffer; start a fresh one
        self._buf = pa.allocate_buffer(1 << 20, resizable=True)
        self._size = 0
        self._offsets = [0]
        return arr


SCHEMA_FIELDS = [
    pa.field("timestamp", pa.timestamp("ns"), nullable=False),
    pa.field("deltaPredicted", pa.bool_(), nullable=False),
    pa.field("cgPredicted", pa.bool_(), nullable=False),
    pa.field("preview", pa.binary(), nullable=False),
    pa.field("highBytePlane", pa.binary(), nullable=False),
    pa.field("lowBytePlane", pa.binary(), nullable=False),
]


def make_schema(
    xsize: int, ysize: int, shifted_left: int, delta: FramePlanes
) -> pa.Schema:
    """Self-describing schema with the compressed delta frame in metadata.

    ``delta``: the delta frame's split planes as a batch of one on the
    device.  Its high plane is stored predicted (CG when the decision
    takes it), its low plane as split; a shift-8 split has none."""
    predicted = frame_ops.predict(delta, None, make_preview=False)
    high = brotli.compress(_host(predicted.high[0]))
    low = brotli.compress(_host(delta.low[0])) if shifted_left != 8 else b""
    cg = bool(predicted.flags[0] & FrameFlags.USE_CG)
    return pa.schema(
        SCHEMA_FIELDS,
        metadata={
            b"xsize": str(xsize).encode(),
            b"ysize": str(ysize).encode(),
            b"shiftedLeft": str(shifted_left).encode(),
            b"deltaFrameHighPlane": high,
            b"deltaFrameLowPlane": low,
            b"deltaFrameCGPredicted": b"true" if cg else b"false",
        },
    )


class ArrowEncoder:
    """push_frame -> futures; RecordBatches delivered to a consumer
    callback.  Each frame's split and prediction run on ``device`` (default
    the card; without one this raises) on the worker pool."""

    def __init__(
        self,
        xsize: int,
        ysize: int,
        shift_to_left_align: int,
        big_endian: bool,
        record_batch_consumer,
        frames_per_batch: int = 10,
        num_workers: int = 2,
        device="cuda",
    ) -> None:
        self._device = resolve_device(device)
        self._xsize = xsize
        self._ysize = ysize
        self._shift = shift_to_left_align
        self._big_endian = big_endian
        self._consumer = record_batch_consumer
        self._frames_per_batch = frames_per_batch
        self._pool = ThreadPoolExecutor(max_workers=num_workers)
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._closing = False
        self._closing_future: Future = Future()
        self._delta: FramePlanes | None = None
        self._delta_batch: FramePlanes | None = None
        self._schema: pa.Schema | None = None
        self._schema_ready = threading.Event()
        self._ts: list = []
        self._dp: list = []
        self._cg: list = []
        self._pv_b = MutableBinaryBuilder()
        self._hi_b = MutableBinaryBuilder()
        self._lo_b = MutableBinaryBuilder()
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
            # fusion_power_video.cc:453-465); see columnar.push_frame
            validate_u8_config(self._shift, self._big_endian)
        img = np.asarray(img, dtype=np.uint16).reshape(self._ysize, self._xsize)
        if self._delta is None:
            planes = self._split(img)
            self._delta_batch = planes
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
            done.set_result(info)
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
        self._schema = make_schema(
            self._xsize, self._ysize, self._shift, self._delta_batch
        )
        self._schema_ready.set()

    def close(self) -> Future:
        with self._lock:
            if not self._closing:
                self._closing = True
                self._queue.put(None)
        return self._closing_future

    def _flush(self) -> None:
        if self._delta is None:
            # no frame was ever pushed: there is no schema to wait for
            # (close() on an empty encoder must not deadlock)
            self._consumer(None)
            return
        self._schema_ready.wait()
        if not self._ts:
            self._consumer(None)
            return
        self._latest_ts = self._ts[-1]
        batch = pa.RecordBatch.from_arrays(
            [
                pa.array(np.asarray(self._ts, np.int64), pa.timestamp("ns")),
                pa.array(self._dp, pa.bool_()),
                pa.array(self._cg, pa.bool_()),
                self._pv_b.finish(),
                self._hi_b.finish(),
                self._lo_b.finish(),
            ],
            schema=self._schema,
        )
        self._ts, self._dp, self._cg = [], [], []
        self._consumer(batch)

    def _compress_row(self, predicted: tuple) -> None:
        """Compress one predicted frame straight into the column builders
        (role of CompressPreparedFrame, arrow/arrow_encoder.cc:97-113)."""
        flags, high, low, preview, timestamp = predicted
        for plane, builder in (
            (preview, self._pv_b),
            (high, self._hi_b),
            (None if flags & FrameFlags.NO_LOW_BYTES else low, self._lo_b),
        ):
            if plane is None or plane.size == 0:
                builder.append_empty()
                continue
            mv = builder.next_item(brotli.max_compressed_size(plane.size))
            builder.advance(brotli.compress_into(plane, mv))
        self._ts.append(timestamp)
        self._dp.append(bool(flags & FrameFlags.USE_DELTA))
        self._cg.append(bool(flags & FrameFlags.USE_CG))

    def _encoder_task(self) -> None:
        try:
            while True:
                item = self._queue.get()
                if item is None:
                    self._flush()
                    self._closing_future.set_result(self._latest_ts)
                    return
                predicted = item.result() if isinstance(item, Future) else item
                self._compress_row(predicted)
                if len(self._ts) >= self._frames_per_batch:
                    self._flush()
        except Exception as e:
            # a failed predict/compress future must surface through
            # close()/join(), not silently kill the serializer thread
            self._closing_future.set_exception(e)

    def join(self) -> None:
        self.close().result()
        self._thread.join(timeout=60)
        self._pool.shutdown(wait=True)


def decode_record_batch(batch: pa.RecordBatch, image_type=None,
                        device="cuda"):
    """Decode every frame of a RecordBatch on ``device`` (default the card;
    without one this raises) -> list of uint16 [H, W] images.

    Counterpart the reference never shipped: reconstructs frames from a
    self-describing RecordBatch using the schema metadata delta planes.
    The delta frame's and the rows' high planes decode as one batch, with
    one K4 launch for the CG-predicted ones."""
    dev = resolve_device(device)
    md = batch.schema.metadata
    xsize = int(md[b"xsize"])
    ysize = int(md[b"ysize"])
    n, size = batch.num_rows, xsize * ysize
    highs = [md[b"deltaFrameHighPlane"]] + [
        v.as_py() for v in batch.column("highBytePlane")]
    cg = [md[b"deltaFrameCGPredicted"] == b"true"] + [
        v.as_py() for v in batch.column("cgPredicted")]
    high = _decode_planes(highs, size, dev).reshape(n + 1, ysize, xsize)
    high = _cg_inverse(high, cg)
    dhigh, high = high[0], high[1:]
    # an empty low stream is a plane not stored
    dlow = _decode_planes([md[b"deltaFrameLowPlane"] or None], size, dev)
    lows = [v.as_py() or None for v in batch.column("lowBytePlane")]
    low = _decode_planes(lows, size, dev).reshape(n, ysize, xsize)
    delta_predicted = [v.as_py() for v in batch.column("deltaPredicted")]
    # NO_LOW_BYTES: the ORIGINAL frame's low plane was all zero and no low
    # stream was stored: output zeros, do NOT add the delta frame's low
    # plane (columnar.extract_image semantics; a frame can be
    # delta-predicted AND low-less at the same time)
    low = _add_where([d and s is not None
                      for d, s in zip(delta_predicted, lows)],
                     low, dlow.reshape(ysize, xsize))
    high = _add_where(delta_predicted, high, dhigh)
    imgs = _host(to_int16(frame_ops.combine_planes(high, low)))
    return list(imgs.view(np.uint16))

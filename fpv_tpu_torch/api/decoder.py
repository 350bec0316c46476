"""Streaming and random-access decoders for FPV1 (reference format) files.

``StreamingDecoder`` is an incremental push-parser with the buffer
semantics of the reference (fusion_power_video.cc:866-956): bytes are
appended, all complete frames are decoded and delivered through a
callback in order, and the unconsumed tail is retained.
``RandomAccessDecoder`` parses header + delta frame + footer once and then
decodes any frame or preview in any order (fusion_power_video.cc:961-1070).
Frames decode in batches on the device (:func:`container.decompress_images`)
and come back as numpy arrays, as the JAX package's do.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from fpv_tpu_torch.api.fpvt_codec import resolve_device
from fpv_tpu_torch.api.frame import ChunkFlags, FramePlanes
from fpv_tpu_torch.format import container
from fpv_tpu_torch.format.bits import out_of_bounds, read_u32le
from fpv_tpu_torch.ops.planes import to_int16

StreamCallback = Callable[[bool, np.ndarray | None, int, int, object], None]

MAX_BATCH_PIXELS = 1 << 26  # pixels per device batch of decode_file


def _to_host_u16(imgs: torch.Tensor) -> np.ndarray:
    """int32 u16 samples on a device -> host uint16 (downloaded as 16-bit
    words into pinned memory, after the current stream's work)."""
    words = to_int16(imgs)
    if words.device.type == "cuda":
        words = words.to("cpu", non_blocking=True)
        torch.cuda.current_stream(imgs.device).synchronize()
    return words.numpy().view(np.uint16)


def _delta_planes(img: torch.Tensor) -> FramePlanes:
    """The decoded delta frame's byte planes, for the delta add."""
    return FramePlanes(high=(img >> 8).to(torch.uint8),
                       low=(img & 0xFF).to(torch.uint8))


def _check_dims(xsize: int, ysize: int) -> None:
    if xsize == 0 or ysize == 0:
        raise ValueError("invalid image dimensions")
    if (xsize > container.MAX_DIM or ysize > container.MAX_DIM
            or xsize * ysize > container.MAX_IMAGE_SIZE):
        raise ValueError("image too large")


class StreamingDecoder:
    """Incremental FPV1 decoder (fusion_power_video.cc:866-956).  The
    frames one :meth:`decode` call completes decode as one batch on
    ``device`` (default the card; without one this raises)."""

    def __init__(self, device="cuda") -> None:
        self._device = resolve_device(device)
        self._xsize = 0
        self._ysize = 0
        self._delta: FramePlanes | None = None
        self._buffer = bytearray()

    def decode(self, data: bytes, callback: StreamCallback,
               payload: object = None) -> None:
        """Feed bytes; invoke ``callback(ok, frame, xsize, ysize, payload)``
        for every newly completed frame, in order."""
        self._buffer += data
        buf = self._buffer
        pos = 0

        def fail(_msg: str) -> None:
            callback(False, None, 0, 0, payload)

        has_header = self._delta is not None
        if self._delta is None and len(buf) > 13:
            xsize = read_u32le(buf, 0)
            ysize = read_u32le(buf, 4)
            pos = 8
            try:
                _check_dims(xsize, ysize)
            except ValueError as e:
                return fail(str(e))
            deltasize = read_u32le(buf, pos)
            if deltasize < 5:
                return fail("too small for delta frame")
            if buf[pos + 4] != ChunkFlags.DELTA_FRAME:
                return fail("not a delta frame")
            if deltasize + pos <= len(buf):
                try:
                    img = container.decompress_image(
                        buf[pos + 5 : pos + deltasize], xsize, ysize,
                        self._device)
                except ValueError:
                    return fail("decompressing delta frame failed")
                self._delta = _delta_planes(img)
                self._xsize, self._ysize = xsize, ysize
                pos += deltasize
                has_header = True
            else:
                pos = 0

        # the complete frames in the buffer, up to a malformed chunk
        mains = []
        bad = None
        while has_header and pos + 9 <= len(buf):
            frame_size = read_u32le(buf, pos)
            flag = buf[pos + 4]
            if flag == ChunkFlags.FRAME_INDEX:
                break  # footer reached, end of frames
            if flag != ChunkFlags.FRAME:
                bad = "not a standard frame"
                break
            if pos + frame_size > len(buf):
                break
            preview_size = read_u32le(buf, pos + 5)
            if preview_size > frame_size:
                bad = "preview size too large"
                break
            mains.append(buf[pos + 9 + preview_size : pos + frame_size])
            pos += frame_size
        if mains:
            imgs, err = container.decompress_images(
                mains, self._xsize, self._ysize, self._device, self._delta)
            for frame in _to_host_u16(imgs):
                callback(True, frame, self._xsize, self._ysize, payload)
            if err is not None:
                return fail("decompressing frame failed")
        if bad is not None:
            return fail(bad)
        del self._buffer[:pos]


class RandomAccessDecoder:
    """Random-access FPV1 decoder (fusion_power_video.cc:961-1070) on
    ``device`` (default the card; without one this raises)."""

    def __init__(self, device="cuda") -> None:
        self._device = resolve_device(device)
        self._data = b""
        self._xsize = 0
        self._ysize = 0
        self._delta: FramePlanes | None = None
        self._delta_img: np.ndarray | None = None
        self._frame_offsets: list[int] = []

    @property
    def xsize(self) -> int:
        return self._xsize

    @property
    def ysize(self) -> int:
        return self._ysize

    @property
    def preview_xsize(self) -> int:
        return self._xsize // 4

    @property
    def preview_ysize(self) -> int:
        return self._ysize // 4

    @property
    def numframes(self) -> int:
        return len(self._frame_offsets)

    @property
    def delta_frame(self) -> np.ndarray:
        """The stream's delta frame (left-aligned uint16 [H, W]); valid
        after :meth:`init`."""
        if self._delta_img is None:
            raise RuntimeError("init() has not succeeded")
        return self._delta_img

    def init(self, data: bytes) -> bool:
        """Parse header, delta frame and footer; True on success."""
        try:
            self._init_raises(data)
            return True
        except (ValueError, IndexError, KeyError):
            return False

    def _init_raises(self, data: bytes) -> None:
        if len(data) < 12:
            raise ValueError("data too small to contain header")
        self._data = bytes(data)
        xsize = read_u32le(data, 0)
        ysize = read_u32le(data, 4)
        _check_dims(xsize, ysize)
        pos = 8
        delta_size = read_u32le(data, pos)
        if out_of_bounds(pos, delta_size, len(data)):
            raise ValueError("out of bounds")
        if delta_size < 5:
            raise ValueError("delta frame too small")
        if data[12] != ChunkFlags.DELTA_FRAME:
            raise ValueError("must begin with delta frame")
        img = container.decompress_image(
            self._data[pos + 5 : pos + delta_size], xsize, ysize,
            self._device)
        self._delta = _delta_planes(img)
        self._delta_img = _to_host_u16(img)
        self._xsize, self._ysize = xsize, ysize
        self._frame_offsets = container.parse_footer(self._data)

    def _main(self, index: int):
        chunk = container.parse_frame_chunk(self._data,
                                            self._frame_offsets[index])
        return memoryview(self._data)[
            chunk.main_start : chunk.main_start + chunk.main_size]

    def _decode_frames_device(self, indices, pool=None) -> torch.Tensor:
        """Frames ``indices`` as one device batch -> int32 [k, H, W] u16
        samples on the decoder's device (one K4 launch for the CG frames);
        ``pool`` (an executor) runs their brotli streams."""
        mains = [self._main(i) for i in indices]
        imgs, err = container.decompress_images(
            mains, self._xsize, self._ysize, self._device, self._delta,
            pool=pool)
        if err is not None:
            raise err
        return imgs

    def _decode_frames(self, indices, pool=None) -> np.ndarray:
        """Frames ``indices`` as one device batch -> uint16 [k, H, W]."""
        return _to_host_u16(self._decode_frames_device(indices, pool))

    def decode_frame(self, index: int) -> np.ndarray:
        """Decode frame ``index`` -> uint16 [H, W]."""
        return self._decode_frames([index])[0]

    def _decode_previews(self, indices, pool=None) -> np.ndarray:
        """Previews of frames ``indices`` as one device batch -> uint8
        [k, H//4, W//4] (one K4 launch for the CG previews)."""
        pdatas = []
        for i in indices:
            chunk = container.parse_frame_chunk(self._data,
                                                self._frame_offsets[i])
            pdatas.append(memoryview(self._data)[
                chunk.preview_start : chunk.preview_start + chunk.preview_size])
        imgs, err = container.decompress_images(
            pdatas, self.preview_xsize, self.preview_ysize, self._device,
            grown_size=(self._xsize * self._ysize) // 16, pool=pool)
        if err is not None:
            raise err
        return (_to_host_u16(imgs) >> 8).astype(np.uint8)

    def decode_preview(self, index: int) -> np.ndarray:
        """Decode the preview of frame ``index`` -> uint8 [H//4, W//4]
        (fusion_power_video.cc:1038-1070): the preview bitstream decoded as
        a (xsize/4, ysize/4) image, its high bytes.  The reference's grown
        CG previews at dimensions that are not multiples of 4 decode too
        (:func:`container.parse_image`)."""
        return self._decode_previews([index])[0]


def decode_file(data: bytes, num_threads: int = 0, dtype=np.uint16,
                device="cuda") -> np.ndarray:
    """One-shot decode of an FPV1 file -> [N, H, W] uint16 numpy.

    Frames decode in device batches of up to ``MAX_BATCH_PIXELS``; with
    ``num_threads`` > 1 their brotli streams decode on that many host
    threads.  ``dtype=np.uint8`` returns the original 8-bit samples of a
    stream encoded from uint8 frames (shift-8 layout: the sample is the
    high byte); FPV1 files record no bit depth, so the caller asserts it."""
    dec = RandomAccessDecoder(device)
    if not dec.init(data):
        raise ValueError("invalid FPV1 file")
    if not dec.numframes:
        raise ValueError("the file holds no frames")
    per = max(1, MAX_BATCH_PIXELS // (dec.xsize * dec.ysize))
    idx = range(dec.numframes)
    batches = [idx[s : s + per] for s in range(0, dec.numframes, per)]
    if num_threads > 1:
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            parts = [dec._decode_frames(b, pool) for b in batches]
    else:
        parts = [dec._decode_frames(b) for b in batches]
    out = parts[0] if len(parts) == 1 else np.concatenate(parts)
    if np.dtype(dtype) == np.uint8:
        return (out >> 8).astype(np.uint8)
    return out.astype(dtype, copy=False)

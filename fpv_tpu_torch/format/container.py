"""FPV1 container format (reference-compatible).

The normative format of fusion_power_video.cc:30-155 with the
code-over-comment corrections (previews are 1/4 scale per dimension,
preview chunk layout per Frame::OutputFull, fusion_power_video.cc:830-846):

    file   := header deltaframe frame* footer
    header := xsize:u32le ysize:u32le
    deltaframe := size:u32le flag:u8=1 image            (size includes itself)
    frame  := size:u32le flag:u8=0 preview_size:u32le   (preview_size includes
              preview_image image                        the preview flags byte)
    image  := flags:u8 [brotli(low)] brotli(high)
    footer := size:u32le flag:u8=2 offset:u64le* count:u64le

Chunk framing and per-image (de)serialization.  Decode is batched
(:func:`decompress_images`): brotli decodes each image's planes straight
into one pinned host batch on host threads, the batch is uploaded once,
and the prediction inverse (one K4 launch for the CG frames, the delta
add) and the plane combine run on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fpv_tpu_torch.api import frame as frame_ops
from fpv_tpu_torch.api.frame import ChunkFlags, FrameFlags, FramePlanes
from fpv_tpu_torch.entropy import brotli
from fpv_tpu_torch.format.bits import out_of_bounds, read_u32le, read_u64le, u32le, u64le

MAX_IMAGE_SIZE = 1_000_000_000  # OOM guard (fusion_power_video.cc:164)
MAX_DIM = 65536


def serialize_image(flags: int, high: np.ndarray, low: np.ndarray | None) -> bytes:
    """Predicted host byte planes -> image bitstream: the flags byte, the
    compressed low plane unless NO_LOW_BYTES, the compressed high plane
    (Frame::ApplyBrotliCompression + OutputCore,
    fusion_power_video.cc:643-688, 820-828)."""
    parts = [bytes([flags])]
    if not flags & FrameFlags.NO_LOW_BYTES:
        parts.append(brotli.compress(low))
    parts.append(brotli.compress(high))
    return b"".join(parts)


def serialize_preview_image(preview: np.ndarray, main_flags: int) -> bytes:
    """Preview image bitstream with flags ``(main & USE_CG) | NO_LOW_BYTES``
    (Frame::OutputFull, fusion_power_video.cc:841-843)."""
    flags = (int(main_flags) & FrameFlags.USE_CG) | FrameFlags.NO_LOW_BYTES
    return bytes([flags]) + brotli.compress(preview)


def serialize_header(xsize: int, ysize: int) -> bytes:
    return u32le(xsize) + u32le(ysize)


def serialize_delta_chunk(image_bitstream: bytes) -> bytes:
    """size:u32 (incl. itself) + chunk flag 1 + image (fusion_power_video.cc:60-65)."""
    size = 4 + 1 + len(image_bitstream)
    return u32le(size) + bytes([ChunkFlags.DELTA_FRAME]) + image_bitstream


def serialize_frame_chunk(preview_bitstream: bytes, image_bitstream: bytes) -> bytes:
    """Frame chunk per Frame::OutputFull (fusion_power_video.cc:830-846);
    the stored preview_size counts the preview's flags byte."""
    total_size = 9 + len(preview_bitstream) + len(image_bitstream)
    return (u32le(total_size) + bytes([ChunkFlags.FRAME])
            + u32le(len(preview_bitstream)) + preview_bitstream
            + image_bitstream)


def serialize_footer(frame_offsets: list[int]) -> bytes:
    """Frame-index footer (Encoder::WriteFrameIndex, fusion_power_video.cc:1185-1197)."""
    size = 5 + 8 * len(frame_offsets) + 8
    return (u32le(size) + bytes([ChunkFlags.FRAME_INDEX])
            + b"".join(u64le(off) for off in frame_offsets)
            + u64le(len(frame_offsets)))


@dataclasses.dataclass
class ParsedFrameChunk:
    """Offsets of one frame chunk's sections within the file."""

    chunk_size: int
    preview_start: int  # offset of preview image bitstream (incl. flags byte)
    preview_size: int  # including the preview flags byte
    main_start: int
    main_size: int


def parse_frame_chunk(data: bytes, pos: int) -> ParsedFrameChunk:
    """Validate + locate the sections of the frame chunk at ``pos``."""
    if out_of_bounds(pos, 9, len(data)):
        raise ValueError("out of bounds")
    frame_size = read_u32le(data, pos)
    if frame_size < 9:
        raise ValueError("frame too small")
    if out_of_bounds(pos, frame_size, len(data)):
        raise ValueError("out of bounds")
    if data[pos + 4] != ChunkFlags.FRAME:
        raise ValueError("not a standard frame")
    preview_size = read_u32le(data, pos + 5)
    if preview_size > frame_size - 9:
        raise ValueError("preview too large")
    return ParsedFrameChunk(
        chunk_size=frame_size,
        preview_start=pos + 9,
        preview_size=preview_size,
        main_start=pos + 9 + preview_size,
        main_size=frame_size - preview_size - 9,
    )


def parse_footer(data: bytes) -> list[int]:
    """Frame offsets from the footer (RandomAccessDecoder::Init,
    fusion_power_video.cc:993-1012)."""
    size = len(data)
    if size < 8:
        raise ValueError("data too small")
    num_frames = read_u64le(data, size - 8)
    if num_frames > size // 16:
        raise ValueError("too many frames")
    footer_size = 5 + 8 * num_frames + 8
    if footer_size > size:
        raise ValueError("footer too large")
    pos = size - footer_size
    if read_u32le(data, pos) != footer_size:
        raise ValueError("footer size mismatch")
    if data[pos + 4] != ChunkFlags.FRAME_INDEX:
        raise ValueError("must end with frame index")
    pos += 5
    return [read_u64le(data, pos + 8 * i) for i in range(num_frames)]


def parse_image(data, xsize: int, ysize: int, high: np.ndarray,
                low: np.ndarray, grown_size: int | None = None) -> int:
    """Host half of DecompressImage (fusion_power_video.cc:296-333): parse
    the flags and decode the low then the high brotli stream (two
    concatenated streams) into the flat uint8 arrays ``high`` and ``low``,
    each at least ``max(xsize * ysize, grown_size)`` bytes; returns the
    flags.  A NO_LOW_BYTES image's low plane is zeros.

    ``grown_size``: an additionally accepted plane length, for previews
    the reference encoded at dimensions that are not multiples of 4.  Its
    preview CG transform iterates ``full_size/16`` entries at stride
    ``xsize/4`` (fusion_power_video.cc:575-586), past its own preview (UB),
    so the coded plane grows to ``full_size/16``.  The CG inverse of the
    leading entries depends only on earlier ones, so inverting the grown
    buffer at stride ``xsize`` and truncating gives the preview exactly.
    This port's encoder never writes such streams."""
    if not len(data):
        raise ValueError("out of bounds")
    flags = data[0]
    if not xsize or not ysize:
        raise ValueError("invalid image dimensions")
    numpixels = xsize * ysize
    grown = grown_size is not None and grown_size > numpixels
    cap = grown_size if grown else numpixels
    pos = 1
    if flags & FrameFlags.NO_LOW_BYTES:
        low[:numpixels] = 0
    else:
        n, pos = brotli.decompress_into(data, pos, low[:cap])
        if n != numpixels and not (grown and n == grown_size):
            raise ValueError("wrong decompressed plane size")
    n, _end = brotli.decompress_into(data, pos, high[:cap])
    if n != numpixels and not (grown and flags & FrameFlags.USE_CG
                               and n == grown_size):
        raise ValueError("wrong decompressed plane size")
    return flags


def _host_batch(n: int, size: int, device: torch.device) -> torch.Tensor:
    """An uninitialized [n, size] uint8 host batch, pinned for a CUDA
    device."""
    return torch.empty((n, size), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


def decompress_images(datas, xsize: int, ysize: int, device,
                      delta: FramePlanes | None = None,
                      grown_size: int | None = None,
                      pool=None) -> tuple[torch.Tensor, ValueError | None]:
    """Batched DecompressImage (fusion_power_video.cc:296-347) on
    ``device`` -> (int32 [k, ysize, xsize] u16 samples of the images
    before the first that failed, that failure or None).

    Brotli runs per image on ``pool`` (an executor; None runs them in
    order on this thread), straight into one host batch; then one upload,
    :func:`frame.unpredict` (one K4 launch for the USE_CG images, the
    delta add for the USE_DELTA ones, which need ``delta``: the delta
    frame's planes) and the combine, on the device.  A grown preview
    (``grown_size``) is inverted at its full height and truncated."""
    device = torch.device(device)
    n = len(datas)
    numpixels = xsize * ysize
    rows = ysize
    if grown_size is not None and grown_size > numpixels and xsize:
        rows = -(-grown_size // xsize)
    high = _host_batch(n, rows * xsize, device)
    low = _host_batch(n, rows * xsize, device)
    hi_np, lo_np = high.numpy(), low.numpy()
    flags = [0] * n
    errors: list[ValueError | None] = [None] * n

    def parse(j: int) -> None:
        try:
            flags[j] = parse_image(datas[j], xsize, ysize, hi_np[j],
                                   lo_np[j], grown_size)
            if flags[j] & FrameFlags.USE_DELTA and delta is None:
                raise ValueError("delta frame not given")
        except ValueError as e:
            errors[j] = e

    if pool is None:
        for j in range(n):
            parse(j)
    else:
        list(pool.map(parse, range(n)))
    k = next((j for j, e in enumerate(errors) if e is not None), n)
    err = errors[k] if k < n else None
    shape = (k, rows, xsize)
    planes = FramePlanes(
        high=high[:k].reshape(shape).to(device, non_blocking=True),
        low=low[:k].reshape(shape).to(device, non_blocking=True),
        flags=flags[:k])
    out = frame_ops.unpredict(planes, delta)
    imgs = frame_ops.combine_planes(out.high[:, :ysize], out.low[:, :ysize])
    return imgs, err


def decompress_image(data, xsize: int, ysize: int, device,
                     delta: FramePlanes | None = None,
                     grown_size: int | None = None) -> torch.Tensor:
    """One image -> int32 [ysize, xsize] u16 samples on ``device``."""
    imgs, err = decompress_images([data], xsize, ysize, device, delta,
                                  grown_size)
    if err is not None:
        raise err
    return imgs[0]

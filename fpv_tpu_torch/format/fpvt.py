"""FPVT container serialization (see docs/FORMAT_FPVT.md).

Host-side layer: pure byte packing/unpacking of headers, sections and plane
streams.  Writes wire format v6 and reads v4-v6.  The compute path
(prediction + rANS) lives in fpv_tpu_torch.api.fpvt_codec and
fpv_tpu_torch.ops.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

from fpv_tpu_torch.entropy.plane_codec import (
    PlaneStream,
    const_plane_stream,
    raw_plane_stream,
)
from fpv_tpu_torch.ops.rans_layout import (
    BLOCK_LANES,
    CODING_CONST,
    CODING_CTX16,
    CODING_ORDER0,
    CODING_RAW,
    CTX_NCTX,
    CTX_NIDX,
    CTX_PROB_SCALE,
    LANES_MIN,
    PROB_SCALE,
    SEG_LEN,
    num_blocks,
    num_segments,
)

MAGIC = b"FPVT"
VERSION = 6  # v6: CODING_RAW stored plane streams (incompressible planes
# store their residual bytes verbatim — rans_layout.CODING_RAW).  v5 added
# prev-frame temporal prediction (F_USE_PREV); v4 added per-stream lane
# counts (narrow streams), CODING_CONST plane streams and preview delta
# prediction (F_PV_USE_DELTA).  Older decoders must reject newer files.
# v4/v5 files read losslessly under v6 semantics (coding 3 and frame-flag
# bit 7 were invalid/reserved before), so existing captures stay readable.
READ_VERSIONS = (4, 5, VERSION)
PROFILE_RANS12 = 1

SECTION_BATCH = 0
SECTION_DELTA = 1
SECTION_INDEX = 2

HEADER_SIZE = 32

# frame flag bits
F_USE_DELTA = 1
F_SPATIAL_SHIFT = 1  # bits 1-2
F_NO_LOW = 8
F_PV_SPATIAL_SHIFT = 4  # bits 4-5
# bit 6: the frame's preview is delta-predicted against the delta frame's
# preview (generate_preview of the delta high plane, which both sides can
# compute).  Applied BEFORE the preview's spatial prediction; on repeated
# frames it zeroes the preview residual so CODING_CONST collapses the whole
# preview stream (the LZ77 role of brotli on exact-repetition corpora,
# fusion_power_video.cc:166-169).
F_PV_USE_DELTA = 64
# bit 7: the frame's main planes are delta-predicted against the PREVIOUS
# frame's reconstructed planes (frame 0 of a batch would fall back to the
# delta section, but encoders anchor it — see fpvt_codec.PREV_ANCHOR).
# Mutually exclusive with F_USE_DELTA.  Decode inverts with a mod-256
# cumulative scan along the frame axis — batch-parallel on device, the
# temporal-prediction design the reference's frame-at-a-time decoder
# cannot express (fusion_power_video.cc:517-544 predicts only against the
# one static delta frame).  Batches stay independently decodable (chains
# never cross a section boundary); random access within a batch walks back
# to the nearest non-prev anchor frame (encoder-bounded to PREV_ANCHOR).
F_USE_PREV = 128
SPATIAL_NONE = 0
SPATIAL_UP = 1
SPATIAL_CG2D = 2


HDR_F_BIG_ENDIAN = 1
# frame 0 of the sequence IS the delta frame: it is stored once (the delta
# section) and batch sections start at frame 1; decoders synthesize frame 0
# from the delta planes.  Avoids coding the first frame twice — without it
# frame 0's all-zero delta residuals mix into the batch's shared tables,
# which costs real mass on incompressible content (the reference gets the
# same refund implicitly: its frame 0 delta-predicts against itself to zero,
# fusion_power_video.cc:517-544 + encode.cc:86-92).
HDR_F_DELTA_IS_FRAME0 = 2


@dataclasses.dataclass
class Header:
    xsize: int
    ysize: int
    shift: int = 0
    big_endian: bool = False
    chunk_log2: int = 9
    frames_per_batch: int = 16
    profile: int = PROFILE_RANS12
    delta_is_frame0: bool = False

    def serialize(self) -> bytes:
        flags = (HDR_F_BIG_ENDIAN if self.big_endian else 0) | (
            HDR_F_DELTA_IS_FRAME0 if self.delta_is_frame0 else 0
        )
        return struct.pack(
            "<4sBBHIIBBHIQ",
            MAGIC,
            VERSION,
            self.profile,
            flags,
            self.xsize,
            self.ysize,
            self.shift,
            self.chunk_log2,
            0,
            self.frames_per_batch,
            0,
        )

    @classmethod
    def parse(cls, data: bytes) -> "Header":
        if len(data) < HEADER_SIZE:
            raise ValueError("data too small for FPVT header")
        (magic, version, profile, flags, xsize, ysize, shift, chunk_log2, _r,
         fpb, _r2) = struct.unpack_from("<4sBBHIIBBHIQ", data, 0)
        if magic != MAGIC:
            raise ValueError("not an FPVT file")
        if version not in READ_VERSIONS:
            raise ValueError(f"unsupported FPVT version {version}")
        # OOM guards, mirroring the reference (fusion_power_video.cc:891-895)
        if not (0 < xsize <= 65536 and 0 < ysize <= 65536):
            raise ValueError("invalid image dimensions")
        if xsize * ysize > 1_000_000_000:
            raise ValueError("image too large")
        if shift > 16 or not (4 <= chunk_log2 <= 16):
            raise ValueError("invalid header parameters")
        if shift > 8 and flags & HDR_F_BIG_ENDIAN:
            # no split/unsplit implementation defines this configuration
            # (ops/planes.validate_shift); a writer cannot have produced it
            raise ValueError("invalid header parameters")
        return cls(
            xsize=xsize,
            ysize=ysize,
            shift=shift,
            big_endian=bool(flags & HDR_F_BIG_ENDIAN),
            chunk_log2=chunk_log2,
            frames_per_batch=fpb,
            profile=profile,
            delta_is_frame0=bool(flags & HDR_F_DELTA_IS_FRAME0),
        )


def _pad8(n: int) -> int:
    return (-n) % 8


def _need(data, pos: int, n: int) -> None:
    """Bounds guard: malformed input raises ValueError, never struct.error
    or IndexError (reference guard style: fusion_power_video.cc:292-294)."""
    if pos < 0 or n < 0 or pos + n > len(data):
        raise ValueError("truncated FPVT data")


def serialize_plane_stream(ps: PlaneStream) -> bytes:
    if ps.coding == CODING_CONST:
        # constant plane batch: 20-byte header only, value in the last u16
        body = struct.pack(
            "<IIIIHH", ps.plane_size, ps.chunk_len, 0, CODING_CONST, 0,
            ps.value,
        )
        size = 4 + len(body)
        return struct.pack("<I", size) + body
    if ps.coding == CODING_RAW:
        # stored plane batch: 20-byte header + the residual bytes verbatim.
        # The num_chunks field holds an Adler-32 of the bytes — the
        # integrity role the per-chunk rANS final states play for coded
        # streams (raw bytes would otherwise corrupt silently).
        n = ps.nframes * ps.plane_size
        raw = ps.payload.tobytes()[:n]
        body = struct.pack(
            "<IIIIHH", ps.plane_size, ps.chunk_len,
            zlib.adler32(raw) & 0xFFFFFFFF, CODING_RAW, 0, 0,
        ) + raw
        size = 4 + len(body)
        pad = _pad8(size)
        return struct.pack("<I", size + pad) + body + b"\0" * pad
    # freq field is always 512 bytes: 256 x u16 (coding=0) or the 32x16
    # per-context u8 tables (coding=1, values <= 128)
    if ps.coding == CODING_CTX16:
        freq_bytes = ps.freq.astype(np.uint8).tobytes()
    else:
        freq_bytes = ps.freq.astype("<u2").tobytes()
    body = (
        struct.pack("<IIIIHH", ps.plane_size, ps.chunk_len, ps.num_chunks,
                    ps.coding, ps.lanes, 0)
        + freq_bytes
        + ps.states.astype("<u4").tobytes()
        + ps.block_counts.astype("<u4").tobytes()
        + ps.payload.astype("<u2").tobytes()
    )
    size = 4 + len(body)
    pad = _pad8(size)
    return struct.pack("<I", size + pad) + body + b"\0" * pad


def parse_plane_stream(
    data: bytes, pos: int, nframes: int, expect_size: int | None = None
) -> tuple[PlaneStream, int]:
    """Parse one plane stream.  ``expect_size``: the plane size implied by
    the file header's frame geometry; when given, a mismatching
    ``plane_size`` field is rejected BEFORE any decode path can allocate
    ``nframes * plane_size`` bytes from a crafted field (CODING_CONST
    streams carry no payload to cross-check against, so this is their only
    size bound)."""
    _need(data, pos, 24)
    (size,) = struct.unpack_from("<I", data, pos)
    end = pos + size
    _need(data, pos, size)
    p = pos + 4
    plane_size, chunk_len, num_chunks, coding, lanes, cval = (
        struct.unpack_from("<IIIIHH", data, p)
    )
    p += 20
    # size/geometry guards apply to EVERY coding, CODING_CONST included
    if not (16 <= chunk_len <= 65536) or chunk_len & (chunk_len - 1):
        raise ValueError("invalid plane-stream chunk length")
    if expect_size is not None and plane_size != expect_size:
        raise ValueError("plane stream size does not match frame geometry")
    if plane_size > 1 << 32 or nframes * plane_size > 16_000_000_000:
        raise ValueError("plane stream too large")
    if coding == CODING_CONST:
        if cval > 255:
            raise ValueError("invalid constant plane value")
        return const_plane_stream(nframes, plane_size, chunk_len, cval), end
    if coding == CODING_RAW:
        n = nframes * plane_size
        _need(data, p, n)
        if p + n > end:
            raise ValueError("plane stream overruns section")
        raw = np.frombuffer(data, dtype=np.uint8, count=n, offset=p).copy()
        # num_chunks carries the Adler-32 of the stored bytes (integrity
        # role of the rANS final-state checks; raw has no coder structure)
        if zlib.adler32(raw.tobytes()) & 0xFFFFFFFF != num_chunks:
            raise ValueError("raw plane stream checksum mismatch")
        return raw_plane_stream(nframes, plane_size, chunk_len, raw), end
    if coding not in (CODING_ORDER0, CODING_CTX16):
        raise ValueError("unknown plane-stream coding")
    if (
        not (LANES_MIN <= lanes <= BLOCK_LANES)
        or lanes & (lanes - 1)
    ):
        raise ValueError("invalid plane-stream lane count")
    expect_chunks = num_blocks(nframes, plane_size, chunk_len, lanes) * lanes
    if num_chunks != expect_chunks:
        raise ValueError("plane-stream chunk count mismatch")
    _need(data, p, 512)
    if coding == CODING_CTX16:
        freq = (
            np.frombuffer(data, dtype=np.uint8, count=CTX_NIDX, offset=p)
            .astype(np.uint16)
            .copy()
        )
        sums = freq.reshape(CTX_NCTX, -1).astype(np.int64).sum(axis=1)
        if not (sums == CTX_PROB_SCALE).all():
            raise ValueError("invalid frequency table")
    else:
        freq = np.frombuffer(data, dtype="<u2", count=256, offset=p).copy()
        if int(freq.astype(np.int64).sum()) != PROB_SCALE:
            raise ValueError("invalid frequency table")
    p += 512
    _need(data, p, 4 * num_chunks)
    states = np.frombuffer(data, dtype="<u4", count=num_chunks, offset=p).copy()
    p += 4 * num_chunks
    nblocks = -(-num_chunks // lanes)
    # one count per (block, segment), block-major (rans_layout SEG_LEN)
    ngroups = nblocks * num_segments(chunk_len)
    _need(data, p, 4 * ngroups)
    block_counts = np.frombuffer(data, dtype="<u4", count=ngroups, offset=p).copy()
    p += 4 * ngroups
    total_words = int(block_counts.astype(np.int64).sum())
    # each chunk emits at most one word per symbol step of its segment
    if ngroups and block_counts.max() > min(chunk_len, SEG_LEN) * lanes:
        raise ValueError("plane-stream block count out of range")
    _need(data, p, 2 * total_words)
    payload = np.frombuffer(data, dtype="<u2", count=total_words, offset=p).copy()
    p += 2 * total_words
    if p > end:
        raise ValueError("plane stream overruns section")
    ps = PlaneStream(
        nframes=nframes,
        plane_size=plane_size,
        chunk_len=chunk_len,
        freq=freq,
        states=states,
        block_counts=block_counts,
        payload=payload,
        coding=coding,
        lanes=lanes,
    )
    return ps, end


def serialize_section(section_type: int, body: bytes) -> bytes:
    return struct.pack("<QB", 9 + len(body), section_type) + body


def serialize_delta_section(
    dflags: int, high: PlaneStream, low: PlaneStream | None
) -> bytes:
    body = bytes([dflags]) + serialize_plane_stream(high)
    if low is not None:
        body += serialize_plane_stream(low)
    return serialize_section(SECTION_DELTA, body)


def serialize_batch_section(
    frame_flags: np.ndarray,
    timestamps: np.ndarray,
    high: PlaneStream,
    low: PlaneStream | None,
    preview: PlaneStream | None,
) -> bytes:
    nframes = len(frame_flags)
    if len(timestamps) != nframes:
        # a mismatch would serialize a section whose fixed-size timestamp
        # region mis-aligns the plane streams — failing only at decode,
        # far from the buggy call
        raise ValueError(
            f"{len(timestamps)} timestamps for {nframes} frames"
        )
    body = struct.pack("<IBBH", nframes, int(low is not None),
                       int(preview is not None), 0)
    body += np.asarray(frame_flags, dtype=np.uint8).tobytes()
    body += np.asarray(timestamps, dtype="<i8").tobytes()
    body += serialize_plane_stream(high)
    if low is not None:
        body += serialize_plane_stream(low)
    if preview is not None:
        body += serialize_plane_stream(preview)
    return serialize_section(SECTION_BATCH, body)


@dataclasses.dataclass
class ParsedBatch:
    frame_flags: np.ndarray
    timestamps: np.ndarray
    high: PlaneStream
    low: PlaneStream | None
    preview: PlaneStream | None


def parse_delta_section(
    data: bytes, pos: int, plane_size: int | None = None
) -> tuple[int, PlaneStream, PlaneStream | None]:
    """``plane_size``: expected bytes per plane (header ysize*xsize);
    readers pass it so crafted size fields are rejected at parse time."""
    _need(data, pos, 10)
    size, stype = struct.unpack_from("<QB", data, pos)
    if stype != SECTION_DELTA:
        raise ValueError("expected delta section")
    _need(data, pos, size)
    p = pos + 9
    dflags = data[p]
    p += 1
    high, p = parse_plane_stream(data, p, 1, expect_size=plane_size)
    low = None
    if not dflags & F_NO_LOW:
        low, p = parse_plane_stream(data, p, 1, expect_size=plane_size)
    return dflags, high, low


def parse_batch_section(
    data: bytes,
    pos: int,
    plane_size: int | None = None,
    preview_size: int | None = None,
) -> ParsedBatch:
    """``plane_size`` / ``preview_size``: expected bytes per frame plane
    (header ysize*xsize and (ysize//4)*(xsize//4)); readers pass them so
    crafted size fields are rejected at parse time."""
    _need(data, pos, 17)
    size, stype = struct.unpack_from("<QB", data, pos)
    if stype != SECTION_BATCH:
        raise ValueError("expected batch section")
    _need(data, pos, size)
    p = pos + 9
    nframes, has_low, has_preview, _ = struct.unpack_from("<IBBH", data, p)
    p += 8
    if not (0 < nframes <= 1 << 20):
        raise ValueError("invalid batch frame count")
    _need(data, p, 9 * nframes)
    flags = np.frombuffer(data, dtype=np.uint8, count=nframes, offset=p).copy()
    p += nframes
    ts = np.frombuffer(data, dtype="<i8", count=nframes, offset=p).copy()
    p += 8 * nframes
    high, p = parse_plane_stream(data, p, nframes, expect_size=plane_size)
    low = preview = None
    if has_low:
        low, p = parse_plane_stream(data, p, nframes, expect_size=plane_size)
    if has_preview:
        preview, p = parse_plane_stream(
            data, p, nframes, expect_size=preview_size
        )
    return ParsedBatch(frame_flags=flags, timestamps=ts, high=high, low=low,
                       preview=preview)


def serialize_footer(batch_offsets: list[tuple[int, int]], total_frames: int) -> bytes:
    """Index footer, O(1) locatable: the last 8 bytes are the footer's own
    size (u32) followed by the magic (reference's footer is likewise sized
    from EOF, fusion_power_video.cc:993-1012)."""
    body = struct.pack("<Q", len(batch_offsets))
    for off, n in batch_offsets:
        body += struct.pack("<QI", off, n)
    body += struct.pack("<Q", total_frames)
    size = 9 + len(body) + 8  # + trailing (footer_size u32, magic)
    body += struct.pack("<I4s", size, MAGIC)
    return serialize_section(SECTION_INDEX, body)


def footer_size(nbatches: int) -> int:
    return 33 + 12 * nbatches


def parse_footer(data: bytes) -> list[tuple[int, int]]:
    """Locate the index footer from the end -> [(offset, nframes), ...]."""
    if len(data) < footer_size(0) or data[-4:] != MAGIC:
        raise ValueError("no FPVT footer")
    (fsize,) = struct.unpack_from("<I", data, len(data) - 8)
    start = len(data) - fsize
    if start < 0 or fsize < footer_size(0):
        raise ValueError("corrupt FPVT footer")
    size, stype = struct.unpack_from("<QB", data, start)
    if stype != SECTION_INDEX or size != fsize:
        raise ValueError("corrupt FPVT footer")
    (nbatches,) = struct.unpack_from("<Q", data, start + 9)
    if fsize != footer_size(nbatches):
        raise ValueError("corrupt FPVT footer")
    out = []
    p = start + 17
    for _ in range(nbatches):
        off, n = struct.unpack_from("<QI", data, p)
        if off >= start or n == 0:
            raise ValueError("corrupt FPVT footer entry")
        out.append((off, n))
        p += 12
    return out

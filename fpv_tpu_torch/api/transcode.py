"""Profile transcoding: FPV1 (reference-compatible) <-> FPVT, on the device.

The migration tool for users of the reference (google/fusion-power-video):
existing .fpv archives convert losslessly to the FPVT profile and back,
without re-running the raw capture pipeline.  Pixels are preserved
exactly, and the bytes equal the JAX package's transcoder's.

FPV1 files do not record the encode-time ``shift``/``big_endian``
arguments (the reference's encode.cc:41-48 takes them on argv), so
:func:`transcode_to_fpvt` takes them as options and verifies the claim
against the samples before trusting it.  FPVT headers record both, so
:func:`transcode_to_fpv1` carries them over.

Frames stay on the device between the two codecs: FPV1 frames decode a
batch at a time (brotli on a host pool, one K4 launch for the batch's CG
frames) straight into the FPVT writer's batched device step, and FPVT
batches decode (K2, K3) straight into the FPV1 encoder's batched device
step, two batches in flight.  Memory is bounded batch-wise.
"""

from __future__ import annotations

import warnings
from concurrent.futures import ThreadPoolExecutor

import torch

from fpv_tpu_torch.api import frame as frame_ops
from fpv_tpu_torch.api.decoder import RandomAccessDecoder
from fpv_tpu_torch.api.encoder import Encoder
from fpv_tpu_torch.api.fpvt_codec import FpvtReader, FpvtWriter, resolve_device
from fpv_tpu_torch.entropy import plane_codec
from fpv_tpu_torch.format import fpvt as fpvt_format
from fpv_tpu_torch.ops import planes as plane_ops

__all__ = ["sniff_profile", "transcode", "transcode_to_fpv1",
           "transcode_to_fpvt"]


def sniff_profile(data) -> str:
    """``"fpvt"`` or ``"fpv1"`` for a container blob.

    FPVT opens with the ``FPVT`` magic; FPV1 has no magic, but its first
    field is xsize u32LE <= 65536 (fusion_power_video.cc:884-895) while the
    magic bytes read as ~1.4e9: the formats cannot collide."""
    return "fpvt" if bytes(data[:4]) == fpvt_format.MAGIC else "fpv1"


def _aligned_to_raw(aligned: torch.Tensor, shift: int, big_endian: bool,
                    verify: bool) -> torch.Tensor:
    """int32 [B, H, W] left-aligned u16 samples -> the raw u16 words (int32,
    same device) a writer re-applying (shift, big_endian) at import turns
    back into ``aligned``.

    ``verify`` re-splits the raw words and compares the recombined planes
    to the input: a shift claim the samples do not satisfy (nonzero bits
    below the shift) is rejected instead of silently dropped, unlike the
    reference CLI, which truncates (fusion_power_video.cc:850-862 is only
    the inverse of import for representable inputs)."""
    if shift == 0 and not big_endian:
        return aligned
    raw = plane_ops.unextract(aligned, shift, big_endian)
    if verify:
        high, low, _nz = plane_ops.split_planes(raw, shift, big_endian)
        if not torch.equal(plane_ops.combine_planes(high, low), aligned):
            raise ValueError(
                f"samples are not representable at shift={shift} "
                f"big_endian={big_endian}: pass the shift the original raw "
                "capture was encoded with (12-bit data: 4), or 0 to store "
                "the left-aligned samples as-is"
            )
    return raw


def transcode_to_fpvt(
    data: bytes,
    shift: int = 0,
    big_endian: bool = False,
    frames_per_batch: int = 16,
    chunk_log2: int = 12,
    num_threads: int = 4,
    device="cuda",
) -> bytes:
    """FPV1 container bytes -> FPVT container bytes (lossless) on
    ``device`` (default the card; without one this raises).

    ``shift``/``big_endian`` stamp the FPVT header's raw-IO contract
    (verified against the samples).  When the FPV1 stream's frame 0 equals
    its delta frame (the layout the reference CLI always produces,
    encode.cc:86-92) the FPVT header sets HDR_F_DELTA_IS_FRAME0, storing
    that frame once.  Frame 0 decodes with the first batch, so the check
    takes no decode of its own: each FPVT batch is one FPV1 decode batch
    (one K4 launch if a frame of it is CG-coded), plus the delta frame's
    at open."""
    if frames_per_batch < 1:
        raise ValueError("frames_per_batch must be at least 1")
    dev = resolve_device(device)
    dec = RandomAccessDecoder(dev)
    if not dec.init(bytes(data)):
        raise ValueError("invalid FPV1 file")
    h, w, n = dec.ysize, dec.xsize, dec.numframes
    delta = frame_ops.combine_planes(dec._delta.high, dec._delta.low)
    fpb = frames_per_batch
    with ThreadPoolExecutor(max_workers=max(1, num_threads)) as pool:

        def decode(start: int, stop: int) -> torch.Tensor:
            return dec._decode_frames_device(range(start, stop), pool)

        buf = decode(0, min(fpb + 1, n)) if n else delta.new_zeros((0, h, w))
        start = buf.shape[0]
        delta_is_frame0 = n > 0 and torch.equal(buf[0], delta)
        skip = 1 if delta_is_frame0 else 0
        wri = FpvtWriter(
            w, h, shift, big_endian, fpb, chunk_log2, device=dev,
            delta_is_frame0=delta_is_frame0,
            narrow=(n - skip) * h * w <= plane_codec.NARROW_MAX_SYMS,
        )
        parts = [wri._init_core(
            _aligned_to_raw(delta[None], shift, big_endian, True), shift,
            big_endian)]
        buf = buf[skip:]
        while buf.shape[0] or start < n:
            if buf.shape[0] < fpb and start < n:
                stop = min(start + fpb - buf.shape[0], n)
                buf = torch.cat([buf, decode(start, stop)])
                start = stop
            batch, buf = buf[:fpb], buf[fpb:]
            raw = _aligned_to_raw(batch, shift, big_endian, True)
            parts.append(wri.add_batch(
                wri._encode_batch_core(raw, shift, big_endian, None),
                raw.shape[0]))
    parts.append(wri.finish())
    return b"".join(parts)


def transcode_to_fpv1(data: bytes, num_threads: int = 4,
                      device="cuda") -> bytes:
    """FPVT container bytes -> FPV1 container bytes (lossless) on
    ``device`` (default the card; without one this raises).

    The output decodes to byte-identical frames, with the reference's own
    decoders too, and reproduces the original raw stream under
    ``fpv-decode`` with the header's recorded shift/endianness.  FPV1 has
    no timestamp field (fusion_power_video.cc:30-155); non-default
    timestamps in the input are dropped with a warning.  Batch n+1's
    decode is issued before batch n goes through the encoder's device
    step."""
    dev = resolve_device(device)
    r = FpvtReader(bytes(data), device=dev)
    hdr = r.header
    shift, big_endian = hdr.shift, hdr.big_endian
    raw_delta = frame_ops.unextract_frame(
        r.delta_frame(), shift, big_endian).view("<u2").reshape(
            hdr.ysize, hdr.xsize)
    chunks: list[bytes] = []

    def cb(out: bytes, _payload: object) -> None:
        chunks.append(out)

    enc = Encoder(num_threads=num_threads, shift=shift,
                  big_endian=big_endian, device=dev)
    enc.init(raw_delta, hdr.xsize, hdr.ysize, cb)
    if hdr.delta_is_frame0:
        # FPVT stores this frame once; FPV1 keeps the reference CLI's
        # layout where frame 0 is also a regular frame (encode.cc:86-92)
        enc.compress_frame(raw_delta, cb)

    def encode(finalize) -> None:
        frames, _pv = finalize()
        raw = _aligned_to_raw(frames, shift, big_endian, False)
        enc._compress_batch(raw, [(cb, None)] * raw.shape[0])

    ts_dropped = False
    pending = []
    for bi in range(r.num_batches):
        fin = r._issue(bi, device_frames=True)
        ts_dropped = ts_dropped or bool((fin.timestamps != -1).any())
        pending.append(fin)
        if len(pending) == 2:
            encode(pending.pop(0))
    for fin in pending:
        encode(fin)
    enc.finish(cb)
    if ts_dropped:
        warnings.warn(
            "FPV1 has no timestamp field; the input's per-frame timestamps "
            "were dropped",
            stacklevel=2,
        )
    return b"".join(chunks)


def transcode(
    data: bytes,
    to_profile: str,
    shift: int = 0,
    big_endian: bool = False,
    frames_per_batch: int = 16,
    chunk_log2: int = 12,
    num_threads: int = 4,
    device="cuda",
) -> bytes:
    """Transcode ``data`` (profile auto-detected) to ``to_profile`` on
    ``device``.

    Same-profile input is returned unchanged (already in the target
    container; re-coding would only burn cycles)."""
    if to_profile not in ("fpv1", "fpvt"):
        raise ValueError(f"unknown profile {to_profile!r}")
    src = sniff_profile(data)
    if src == to_profile:
        return bytes(data)
    if to_profile == "fpvt":
        return transcode_to_fpvt(
            data, shift, big_endian, frames_per_batch, chunk_log2,
            num_threads, device,
        )
    return transcode_to_fpv1(data, num_threads, device)

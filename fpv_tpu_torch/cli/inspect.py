"""``fpv-inspect``: byte-level accounting of an FPVT or FPV1 file.

Prints where every byte goes: per section and per plane stream, FPVT
streams split into tables / chunk states / group counts / rANS payload,
FPV1 frames into low / high / preview brotli streams and framing.  The
profile is auto-detected from the file bytes.  The dicts and the report
text equal the JAX package's ``fpv-inspect``.  ``--check`` decodes every
batch (FPVT: K2 and K3) or frame and preview (FPV1: K4) on the device.

Usage: python -m fpv_tpu_torch.cli.inspect [--check] [--device cuda|cpu] file
(or inspect_bytes(data) / inspect_fpv1_bytes(data))
"""

from __future__ import annotations

import struct
import sys

from fpv_tpu_torch.format import fpvt
from fpv_tpu_torch.utils.platform import open_device, take_device


def inspect_bytes(data: bytes) -> dict:
    """Full-file accounting -> nested dict (also printable via main)."""
    header = fpvt.Header.parse(data)
    out = {
        "file_bytes": len(data),
        "header_bytes": fpvt.HEADER_SIZE,
        "sections": [],
    }
    # geometry-validated parses, like the readers: crafted plane_size /
    # nframes fields must not drive a read-only accounting tool into
    # multi-GB allocations
    psize = header.ysize * header.xsize
    pvsize = (header.ysize // 4) * (header.xsize // 4)
    pos = fpvt.HEADER_SIZE
    while pos < len(data):
        if len(data) - pos < 9:
            raise ValueError("truncated section header")
        size, stype = struct.unpack_from("<QB", data, pos)
        # a section is at least its own (size, type) header; a crafted
        # size=0 would otherwise loop here forever
        if size < 9 or size > len(data) - pos:
            raise ValueError("corrupt section size")
        if stype == fpvt.SECTION_DELTA:
            _dflags, hs, ls = fpvt.parse_delta_section(
                data, pos, plane_size=psize
            )
            entry = {
                "type": "delta",
                "bytes": size,
                "planes": {"high": fpvt.plane_stream_accounting(hs)},
            }
            if ls is not None:
                entry["planes"]["low"] = fpvt.plane_stream_accounting(ls)
            out["sections"].append(entry)
        elif stype == fpvt.SECTION_BATCH:
            pb = fpvt.parse_batch_section(
                data, pos, plane_size=psize, preview_size=pvsize
            )
            entry = {
                "type": "batch",
                "bytes": size,
                "nframes": len(pb.frame_flags),
                # per-frame temporal modes (v5): static delta / prev-frame
                "frames_delta": int(
                    ((pb.frame_flags & fpvt.F_USE_DELTA) != 0).sum()
                ),
                "frames_prev": int(
                    ((pb.frame_flags & fpvt.F_USE_PREV) != 0).sum()
                ),
                "flags_ts_bytes": 9 * len(pb.frame_flags),
                "planes": {"high": fpvt.plane_stream_accounting(pb.high)},
            }
            if pb.low is not None:
                entry["planes"]["low"] = fpvt.plane_stream_accounting(pb.low)
            if pb.preview is not None:
                entry["planes"]["preview"] = fpvt.plane_stream_accounting(
                    pb.preview)
            out["sections"].append(entry)
        elif stype == fpvt.SECTION_INDEX:
            out["sections"].append({"type": "index", "bytes": size})
        else:
            raise ValueError(f"unknown section type {stype}")
        pos += size
    # totals by component across all plane streams
    totals = {"tables": 0, "states": 0, "counts": 0, "payload": 0,
              "stream_headers": 0}
    for sec in out["sections"]:
        for br in sec.get("planes", {}).values():
            for k in totals:
                totals[k] += br[k]
    out["totals"] = totals
    out["npixels_hint"] = header.xsize * header.ysize
    return out


def format_report(info: dict) -> str:
    lines = [f"file: {info['file_bytes']} B"]
    for sec in info["sections"]:
        extra = f" x{sec['nframes']}" if "nframes" in sec else ""
        if sec.get("frames_prev") or sec.get("frames_delta"):
            extra += (f" (delta {sec['frames_delta']}, "
                      f"prev {sec['frames_prev']})")
        lines.append(f"  [{sec['type']}{extra}] {sec['bytes']} B")
        for name, br in sec.get("planes", {}).items():
            lines.append(
                f"    {name:8s} {br['total']:>10d} B  "
                f"(tables {br['tables']}, states {br['states']}, "
                f"counts {br['counts']}, payload {br['payload']}, "
                f"hdr {br['stream_headers']}, coding {br['coding']})"
            )
    t = info["totals"]
    lines.append(
        f"  totals: tables {t['tables']}  states {t['states']}  "
        f"counts {t['counts']}  payload {t['payload']}  "
        f"stream-hdrs {t['stream_headers']}"
    )
    return "\n".join(lines)


def inspect_fpv1_bytes(data: bytes) -> dict:
    """FPV1 (reference-format) accounting -> nested dict.

    The two brotli streams inside an image bitstream are concatenated with
    no length prefix (fusion_power_video.cc:316-320); the low/high boundary
    is found the way the reference's own decoder finds it: by decoding the
    low stream (at most one plane's bytes) and taking its end position."""
    from fpv_tpu_torch.api.frame import FrameFlags
    from fpv_tpu_torch.entropy.brotli import decompress_stream
    from fpv_tpu_torch.format import container
    from fpv_tpu_torch.format.bits import read_u32le

    if len(data) < 14:
        raise ValueError("not an FPV1 file (too small)")
    xsize, ysize = read_u32le(data, 0), read_u32le(data, 4)
    if not (0 < xsize <= container.MAX_DIM and 0 < ysize <= container.MAX_DIM):
        raise ValueError("invalid FPV1 dimensions")

    def image_breakdown(pos: int, size: int) -> dict:
        flags = data[pos]
        p, end = pos + 1, pos + size
        low = 0
        if not flags & FrameFlags.NO_LOW_BYTES:
            _, p2 = decompress_stream(data, p, max_size=xsize * ysize)
            low = p2 - p
            p = p2
        return {"flags": flags, "total": size, "low": low, "high": end - p}

    out = {
        "file_bytes": len(data),
        "header_bytes": 8,
        "profile": "fpv1",
        "sections": [],
        "frames": [],
    }
    # delta-frame chunk: size:u32 (incl itself) + chunk flag 1 + image
    dsize = read_u32le(data, 8)
    if dsize < 5 or 8 + dsize > len(data) or data[12] != 1:
        raise ValueError("corrupt FPV1 delta chunk")
    out["sections"].append(
        {"type": "delta", "bytes": dsize,
         "image": image_breakdown(13, dsize - 5)}
    )
    pos = 8 + dsize
    framing = 8 + 5  # header + delta chunk framing
    while pos < len(data):
        if len(data) - pos < 5:
            raise ValueError("truncated chunk")
        size = read_u32le(data, pos)
        if data[pos + 4] == container.ChunkFlags.FRAME_INDEX:
            out["sections"].append(
                {"type": "index", "bytes": len(data) - pos}
            )
            framing += len(data) - pos
            break
        fc = container.parse_frame_chunk(data, pos)
        entry = {
            "bytes": size,
            "preview": fc.preview_size,
            "main": image_breakdown(fc.main_start, fc.main_size),
        }
        framing += 9  # size + chunk flag + preview_size fields
        out["frames"].append(entry)
        pos += size
    out["totals"] = {
        "low": sum(f["main"]["low"] for f in out["frames"]),
        "high": sum(f["main"]["high"] for f in out["frames"]),
        "preview": sum(f["preview"] for f in out["frames"]),
        "framing": framing + len(out["frames"]),  # + per-image flags bytes
    }
    out["npixels_hint"] = xsize * ysize
    return out


def format_report_fpv1(info: dict) -> str:
    lines = [f"file: {info['file_bytes']} B  (FPV1)"]
    for sec in info["sections"]:
        if sec["type"] == "delta":
            im = sec["image"]
            lines.append(
                f"  [delta] {sec['bytes']} B  "
                f"(low {im['low']}, high {im['high']}, flags {im['flags']})"
            )
        else:
            lines.append(f"  [{sec['type']}] {sec['bytes']} B")
    frames = info["frames"]
    if len(frames) <= 32:
        for i, f in enumerate(frames):
            m = f["main"]
            lines.append(
                f"  [frame {i}] {f['bytes']} B  (low {m['low']}, "
                f"high {m['high']}, preview {f['preview']}, "
                f"flags {m['flags']})"
            )
    t = info["totals"]
    lines.append(
        f"  frames: {len(frames)}  totals: low {t['low']}  high {t['high']}"
        f"  previews {t['preview']}  framing {t['framing']}"
    )
    return "\n".join(lines)


def check_fpv1_bytes(data: bytes, device="cuda") -> list[str]:
    """Decode-verify every FPV1 frame and preview on ``device`` -> failure
    strings.  Frames and previews decode in device batches (one K4 launch
    each for a batch's CG frames and CG previews); a batch that fails is
    walked frame by frame to name each failure."""
    from fpv_tpu_torch.api.decoder import MAX_BATCH_PIXELS, RandomAccessDecoder

    dec = RandomAccessDecoder(device)
    if not dec.init(bytes(data)):
        return ["unreadable file: header/delta/footer parse failed"]
    failures: list[str] = []
    per = max(1, MAX_BATCH_PIXELS // (dec.xsize * dec.ysize))
    for s in range(0, dec.numframes, per):
        idx = range(s, min(s + per, dec.numframes))
        try:
            dec._decode_frames(idx)
            dec._decode_previews(idx)
            continue
        except ValueError:
            pass
        for i in idx:
            try:
                dec.decode_frame(i)
                dec.decode_preview(i)
            except ValueError as e:
                failures.append(f"frame {i}: {e}")
    return failures


def check_bytes(data: bytes, device="cuda") -> list[str]:
    """Decode-verify every batch section on ``device`` -> failure strings.

    The rANS chunk states double as integrity checks (rans_layout docs):
    a corrupt payload that still parses decodes to mismatching final
    states, which K2's ``ok`` flags surface as ValueError.  This walks the
    file's sections through the real decode path and reports per-batch
    results, usable without the original raw capture."""
    from fpv_tpu_torch.api.fpvt_codec import FpvtReader

    failures: list[str] = []
    try:
        rdr = FpvtReader(data, device=device)
    except ValueError as e:
        return [f"unreadable file: {e}"]
    for i in range(rdr.num_batches):
        try:
            rdr.decode_batch(i)
        except ValueError as e:
            failures.append(f"batch {i}: {e}")
    return failures


def main(argv=None) -> int:
    argv, device = take_device(argv if argv is not None else sys.argv[1:])
    check = "--check" in argv
    if check:
        argv.remove("--check")
    if len(argv) != 1:
        print("usage: fpv-inspect [--check] [--device cuda|cpu] file",
              file=sys.stderr)
        return 2
    dev = open_device(device, "fpv-inspect")
    if dev is None:
        return 1
    with open(argv[0], "rb") as f:
        data = f.read()
    is_fpvt = data[:4] == fpvt.MAGIC
    try:
        if is_fpvt:
            print(format_report(inspect_bytes(data)))
        else:
            print(format_report_fpv1(inspect_fpv1_bytes(data)))
    except ValueError as e:
        # a section that fails parse-time validation (truncation, crafted
        # sizes, raw checksum mismatch) must not abort --check: the check
        # pass reports it per batch with the real decode path
        print(f"report unavailable: {e}", file=sys.stderr)
        if not check:
            return 1
    if check:
        failures = (check_bytes(data, dev) if is_fpvt
                    else check_fpv1_bytes(data, dev))
        for msg in failures:
            print(f"CHECK FAIL: {msg}", file=sys.stderr)
        print("check: " + ("FAILED" if failures else "ok (all batches decode)"))
        return 1 if failures else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI benchmark + roundtrip verifier, mirroring the reference harness.

Argv contract (benchmark.cc:288-327, parse order), plus the device:

    python -m fpv_tpu_torch.cli.benchmark filename xsize ysize big_endian
        shift [maxframes] [threads] [--profile fpv1|fpvt] [--device cuda|cpu]

Encodes the raw capture (timed), then verifies the byte-exact round trip
through both decode paths (FPV1: the streaming decoder in 64 KiB pieces,
then the random-access decoder frame by frame, each frame one K4 chain on
the card as the reference harness decodes it; FPVT: every batch), then
prints per-frame and total statistics to stderr like PrintBenchmark
(benchmark.cc:68-85).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from fpv_tpu_torch.utils.platform import open_device, take_device


def print_benchmark(label, pixels, size, t=0.0, numframes=0):
    msg = f"{label}: {size} bytes"
    if pixels:
        msg += f", {size / pixels * 8:.4g} bpp"
    if numframes > 1:
        msg += f", bytes per frame: {size / numframes:.6g}"
    if t > 0:
        msg += (
            f", time: {t*1000:.4g} ms, speed: {pixels/t/1e6:.4g} MP/s"
            f", frames per second: {numframes/t:.4g}"
        )
    sys.stderr.write(msg + "\n")


def main(argv: list[str] | None = None) -> int:
    argv, device = take_device(sys.argv[1:] if argv is None else argv)
    profile = "fpv1"
    if "--profile" in argv:
        i = argv.index("--profile")
        if i + 1 >= len(argv):
            argv = []  # trailing --profile without a value: show usage
        else:
            profile = argv[i + 1]
            del argv[i : i + 2]
    if len(argv) < 5:
        sys.stderr.write(
            "Usage: fpv-benchmark filename xsize ysize big_endian shift"
            " [maxframes] [threads] [--profile fpv1|fpvt]"
            " [--device cuda|cpu]\n"
        )
        return 1
    filename = argv[0]
    xsize, ysize, big_endian, shift = (int(a) for a in argv[1:5])
    maxframes = int(argv[5]) if len(argv) > 5 else 0
    threads = int(argv[6]) if len(argv) > 6 else 4
    dev = open_device(device, "fpv-benchmark")
    if dev is None:
        return 1

    framesize = xsize * ysize * 2
    with open(filename, "rb") as f:
        raw = f.read(maxframes * framesize if maxframes else -1)
    num = len(raw) // framesize
    if num * framesize != len(raw):
        sys.stderr.write("raw filesize is not a multiple of framesize\n")
    raw = raw[: num * framesize]
    # a writable copy: the device upload wraps it in a tensor
    frames = np.frombuffer(bytearray(raw), dtype="<u2").reshape(
        num, ysize, xsize)
    numpixels = xsize * ysize
    total_pixels = num * numpixels

    from fpv_tpu_torch.api.frame import unextract_frame

    if profile == "fpvt":
        from fpv_tpu_torch.api.fpvt_codec import FpvtReader, FpvtWriter

        t0 = time.time()
        w = FpvtWriter(xsize, ysize, shift=shift, big_endian=bool(big_endian),
                       device=dev)
        parts = [w.init(frames[0])]
        fpb = w.header.frames_per_batch
        for s in range(0, num, fpb):
            parts.append(w.encode_batch(frames[s : s + fpb]))
        parts.append(w.finish())
        data = b"".join(parts)
        t = time.time() - t0
        print_benchmark("total", total_pixels, len(data), t, num)

        sys.stderr.write("verifying random access decoder...\n")
        r = FpvtReader(data, device=dev)
        if r.numframes != num:
            sys.stderr.write(f"Error: {r.numframes} frames, want {num}\n")
            return 1
        idx = 0
        for bi in range(r.num_batches):
            imgs = r.decode_batch(bi)
            for i in range(imgs.shape[0]):
                after = unextract_frame(imgs[i], shift, bool(big_endian)).tobytes()
                if after != raw[idx * framesize : (idx + 1) * framesize]:
                    sys.stderr.write(f"Error: roundtrip not equal! {idx}\n")
                    return 1
                idx += 1
        sys.stderr.write("ok\n")
        return 0

    from fpv_tpu_torch.api.decoder import RandomAccessDecoder, StreamingDecoder
    from fpv_tpu_torch.api.encoder import ENCODE_BATCH, Encoder

    chunks: list[bytes] = []

    def frame_cb(data: bytes, payload):
        chunks.append(data)
        print_benchmark(f"frame {payload}", numpixels, len(data))

    def header_cb(data: bytes, _payload):
        chunks.append(data)
        print_benchmark("header", 0, len(data))

    def footer_cb(data: bytes, _payload):
        chunks.append(data)
        print_benchmark("footer", 0, len(data))

    t0 = time.time()
    enc = Encoder(num_threads=threads, shift=shift,
                  big_endian=bool(big_endian), device=dev)
    enc.init(frames[0], xsize, ysize, header_cb)
    # ENCODE_BATCH frames per device step; the callbacks fire per frame
    for s in range(0, num, ENCODE_BATCH):
        part = frames[s : s + ENCODE_BATCH]
        enc._compress_batch(part, [(frame_cb, s + j) for j in range(len(part))])
    enc.finish(footer_cb)
    total_time = time.time() - t0
    compressed = b"".join(chunks)
    print_benchmark("total", total_pixels, len(compressed), total_time, num)

    sys.stderr.write("verifying streaming decoder...\n")
    sdec = StreamingDecoder(device=dev)
    decoded = 0

    def verify_cb(ok, image, xs, ys, _p):
        nonlocal decoded
        if not ok:
            sys.stderr.write("StreamingDecoder decode failed\n")
            raise SystemExit(1)
        after = unextract_frame(image, shift, bool(big_endian)).tobytes()
        if after != raw[decoded * framesize : (decoded + 1) * framesize]:
            sys.stderr.write(f"Error: roundtrip not equal! {decoded}\n")
            raise SystemExit(1)
        decoded += 1

    for pos in range(0, len(compressed), 65536):
        sdec.decode(compressed[pos : pos + 65536], verify_cb)
    if decoded != num:
        sys.stderr.write(f"Error: not all frames decoded: {decoded} / {num}\n")
        return 1
    sys.stderr.write("ok\nverifying random access decoder...\n")

    rdec = RandomAccessDecoder(device=dev)
    if not rdec.init(compressed):
        sys.stderr.write("RandomAccessDecoder::Init failed\n")
        return 1
    if rdec.numframes != num or rdec.xsize != xsize or rdec.ysize != ysize:
        sys.stderr.write("RandomAccessDecoder::Init mismatch\n")
        return 1
    for i in range(num):
        image = rdec.decode_frame(i)
        rdec.decode_preview(i)
        after = unextract_frame(image, shift, bool(big_endian)).tobytes()
        if after != raw[i * framesize : (i + 1) * framesize]:
            sys.stderr.write(f"Error: roundtrip not equal! {i}\n")
            return 1
    sys.stderr.write("ok\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

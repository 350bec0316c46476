"""CLI encoder: raw uint16 frames on stdin -> compressed stream on stdout.

Same argv contract as the reference tool (encode.cc:41-48: its usage
string lists ``shift big_endian`` but it PARSES ``big_endian shift``; the
parse order is the contract), plus the device:

    python -m fpv_tpu_torch.cli.encode xsize ysize big_endian shift [threads]
        [--profile fpv1|fpvt] [--device cuda|cpu]

The default profile is fpv1 (byte-compatible with the reference decoder);
the default device is the card.  The bytes equal the JAX package's
``fpv-encode`` on the same stdin.
"""

from __future__ import annotations

import sys

import numpy as np

from fpv_tpu_torch.utils.platform import open_device, take_device


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
    if len(argv) < 4:
        sys.stderr.write(
            "Usage: fpv-encode xsize ysize big_endian shift [threads]"
            " [--profile fpv1|fpvt] [--device cuda|cpu] < infile > outfile\n"
            "    xsize, ysize: frame size in pixels\n"
            "    big_endian: endianness of the raw input data, 0 or 1\n"
            "    shift: bits to shift left so MSBs are used (12-bit data: 4)\n"
        )
        return 1
    xsize, ysize, big_endian, shift = (int(a) for a in argv[:4])
    num_threads = int(argv[4]) if len(argv) > 4 else 4
    if not (0 < xsize <= 65536 and 0 < ysize <= 65536):
        sys.stderr.write(f"invalid xsize, ysize: {xsize} {ysize}\n")
        return 1
    if shift > 16:
        sys.stderr.write(f"invalid shift: {shift}\n")
        return 1
    dev = open_device(device, "fpv-encode")
    if dev is None:
        return 1

    framesize = xsize * ysize * 2
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer

    def read_frame() -> np.ndarray | None:
        buf = stdin.read(framesize)
        if len(buf) < framesize:
            return None
        # a writable copy: the device upload wraps it in a tensor
        return np.frombuffer(bytearray(buf), dtype="<u2").reshape(ysize, xsize)

    if profile == "fpvt":
        from fpv_tpu_torch.api.fpvt_codec import FpvtWriter

        # narrow=False: a pipe's total length is unknown, so the small-file
        # policy cannot apply, and a long pipe must not code per plane
        writer = FpvtWriter(
            xsize, ysize, shift=shift, big_endian=bool(big_endian),
            device=dev, delta_is_frame0=True, narrow=False,
        )
        batch: list[np.ndarray] = []
        initialized = False
        while (img := read_frame()) is not None:
            if not initialized:
                # the first frame IS the delta frame (HDR_F_DELTA_IS_FRAME0):
                # stored once; the decoder synthesizes it as frame 0
                stdout.write(writer.init(img))
                initialized = True
                continue
            batch.append(img)
            if len(batch) == writer.header.frames_per_batch:
                stdout.write(writer.encode_batch(np.stack(batch)))
                batch.clear()
        if batch:
            stdout.write(writer.encode_batch(np.stack(batch)))
        if initialized:
            stdout.write(writer.finish())
        return 0

    from fpv_tpu_torch.api.encoder import ENCODE_BATCH, Encoder

    enc = Encoder(num_threads=num_threads, shift=shift,
                  big_endian=bool(big_endian), device=dev)

    def write_cb(data: bytes, _payload: object) -> None:
        stdout.write(data)

    # frames go through the device step ENCODE_BATCH at a time; each
    # frame's chunk is written in order as its brotli streams finish
    batch = []
    while (img := read_frame()) is not None:
        if not batch and enc._delta is None:
            enc.init(img, xsize, ysize, write_cb)
        batch.append(img)
        if len(batch) == ENCODE_BATCH:
            enc._compress_batch(np.stack(batch), [(write_cb, None)] * len(batch))
            batch.clear()
    if batch:
        enc._compress_batch(np.stack(batch), [(write_cb, None)] * len(batch))
    enc.finish(write_cb)
    return 0


if __name__ == "__main__":
    sys.exit(main())

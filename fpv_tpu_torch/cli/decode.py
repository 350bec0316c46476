"""CLI decoder: compressed stream on stdin -> raw uint16 frames on stdout.

Argv contract of the reference (decode.cc:41-44), plus the device:

    python -m fpv_tpu_torch.cli.decode xsize ysize big_endian shift
        [--device cuda|cpu] < infile > outfile

The profile is sniffed from the first 4 bytes (FPVT magic or an FPV1
header).  FPVT files are read whole and decode batch by batch with batch
n+1 issued on the card before batch n is finalized and written (the
reader's issue/finalize, as ``decode_file_fpvt``); FPV1 streams feed the
streaming decoder in 1 MiB blocks like the reference (decode.cc:67-77).
The stdout bytes equal the JAX package's ``fpv-decode``.
"""

from __future__ import annotations

import sys

from fpv_tpu_torch.utils.platform import open_device, take_device


def main(argv: list[str] | None = None) -> int:
    argv, device = take_device(sys.argv[1:] if argv is None else argv)
    if len(argv) != 4:
        sys.stderr.write(
            "Usage: fpv-decode xsize ysize big_endian shift"
            " [--device cuda|cpu] < infile > outfile\n"
        )
        return 1
    xsize, ysize, big_endian, shift = (int(a) for a in argv)
    if not (0 < xsize <= 65536 and 0 < ysize <= 65536):
        sys.stderr.write(f"invalid xsize, ysize: {xsize} {ysize}\n")
        return 1
    if shift > 16:
        sys.stderr.write(f"invalid shift: {shift}\n")
        return 1
    dev = open_device(device, "fpv-decode")
    if dev is None:
        return 1

    from fpv_tpu_torch.api.frame import unextract_frame

    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    head = stdin.read(4)
    count = 0

    def write(frame) -> None:
        nonlocal count
        stdout.write(unextract_frame(frame, shift, bool(big_endian)).tobytes())
        sys.stderr.write(f"extracted frame {count}\n")
        count += 1

    if head == b"FPVT":
        from fpv_tpu_torch.api.fpvt_codec import FpvtReader

        r = FpvtReader(head + stdin.read(), device=dev)
        if r.header.delta_is_frame0:
            write(r.frame0())
        # at most one batch ahead: a blocked stdout pipe applies
        # backpressure instead of growing the heap
        pending = []
        for bi in range(r.num_batches):
            pending.append(r._issue(bi))
            if len(pending) == 2:
                for frame in pending.pop(0)()[0]:
                    write(frame)
        for fin in pending:
            for frame in fin()[0]:
                write(frame)
        return 0

    from fpv_tpu_torch.api.decoder import StreamingDecoder

    dec = StreamingDecoder(device=dev)

    def cb(ok, frame, _xs, _ys, _payload) -> None:
        if not ok:
            sys.stderr.write("decompressing frame failed\n")
            raise SystemExit(1)
        write(frame)

    block = 1 << 20
    dec.decode(head, cb)
    while chunk := stdin.read(block):
        dec.decode(chunk, cb)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI transcoder: convert between the FPV1 and FPVT container profiles.

    python -m fpv_tpu_torch.cli.transcode fpvt [shift] [big_endian]
        [--device cuda|cpu] < in.fpv  > out.fpvt
    python -m fpv_tpu_torch.cli.transcode fpv1 [--device cuda|cpu]
        < in.fpvt > out.fpv

The input profile is auto-detected (FPVT magic vs FPV1 header).  Pixels
are preserved exactly; ``shift``/``big_endian`` only apply to the FPV1 ->
FPVT direction (FPV1 files do not record them, encode.cc:41-48, and the
claim is verified against the samples).  FPVT -> FPV1 carries the
header's recorded values over.  The bytes equal the JAX package's
``fpv-transcode``.
"""

from __future__ import annotations

import sys

from fpv_tpu_torch.utils.platform import open_device, take_device


def main(argv: list[str] | None = None) -> int:
    argv, device = take_device(sys.argv[1:] if argv is None else argv)
    if len(argv) < 1 or argv[0] not in ("fpv1", "fpvt"):
        sys.stderr.write(
            "Usage: fpv-transcode fpvt|fpv1 [shift] [big_endian]"
            " [--device cuda|cpu] < infile > outfile\n"
            "    fpvt|fpv1: target profile (input auto-detected)\n"
            "    shift, big_endian: raw-IO contract to stamp on the FPVT\n"
            "      header (FPV1 -> FPVT only; verified against the data)\n"
        )
        return 1
    to_profile = argv[0]
    shift = int(argv[1]) if len(argv) > 1 else 0
    big_endian = bool(int(argv[2])) if len(argv) > 2 else False
    dev = open_device(device, "fpv-transcode")
    if dev is None:
        return 1

    from fpv_tpu_torch.api.transcode import transcode

    data = sys.stdin.buffer.read()
    try:
        out = transcode(data, to_profile, shift=shift, big_endian=big_endian,
                        device=dev)
    except ValueError as e:
        sys.stderr.write(f"transcode failed: {e}\n")
        return 1
    sys.stdout.buffer.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

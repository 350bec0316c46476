"""FPV1 compatibility profile on the port: the reference's file format.

The counterpart of the JAX package's ``examples/fpv1_compat.py``: encode
12-bit frames as FPV1, decode them losslessly (one-shot, streaming in
pieces, random access with previews), and migrate the archive to FPVT and
back with the pixels unchanged.  The bytes equal the JAX package's
``encode_file`` (held in tests/test_torch_fpv1.py).

    python -m fpv_tpu_torch.examples.fpv1_compat [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np

import fpv_tpu_torch
from fpv_tpu_torch.api.frame import unextract_frame
from fpv_tpu_torch.utils import testdata
from fpv_tpu_torch.utils.platform import argv_device


def main(argv: list[str] | None = None) -> None:
    _argv, device = argv_device(argv, "fpv1_compat")
    # 12-bit sensor data, left-aligned by shift=4 inside the codec
    frames = testdata.plasma_frames(8, 128, 160, bits=12)
    raw = testdata.to_raw_bytes(frames)  # little-endian u16 capture
    imgs = np.frombuffer(raw, dtype="<u2").reshape(8, 128, 160)

    data = fpv_tpu_torch.encode_file(imgs, shift=4, num_threads=2,
                                     device=device)
    print(f"FPV1: {len(raw)} raw -> {len(data)} bytes "
          f"({8 * len(data) / imgs.size:.3f} bpp)")

    # decode returns LEFT-ALIGNED frames (the reference's DecodeFrame);
    # unextract_frame restores the raw values
    out = fpv_tpu_torch.decode_file(data, device=device)
    rest = np.stack([unextract_frame(f, shift=4, big_endian=False)
                     for f in out])
    assert rest.tobytes() == raw, "lossless roundtrip"

    # streaming decode with arbitrary chunking
    got = []
    dec = fpv_tpu_torch.StreamingDecoder(device=device)
    for i in range(0, len(data), 64 * 1024):
        dec.decode(data[i : i + 64 * 1024],
                   lambda ok, img, x, y, payload: got.append(img))
    assert len(got) == 8
    assert all((g == o).all() for g, o in zip(got, out)), "streaming"

    # random access + 1/4-scale preview
    r = fpv_tpu_torch.RandomAccessDecoder(device=device)
    assert r.init(data)
    frame3 = r.decode_frame(3)
    preview3 = r.decode_preview(3)
    assert (frame3 == out[3]).all(), "random access"
    print(f"random access: frame {frame3.shape}, preview {preview3.shape}")

    # migrate the archive to the device-native container and back without
    # re-running the capture pipeline: pixels preserved exactly
    fpvt_data = fpv_tpu_torch.transcode_to_fpvt(data, shift=4, device=device)
    back = fpv_tpu_torch.transcode_to_fpv1(fpvt_data, device=device)
    assert np.array_equal(fpv_tpu_torch.decode_file(back, device=device), out)
    print(f"transcode: FPV1 {len(data)} B -> FPVT {len(fpvt_data)} B -> "
          f"FPV1 {len(back)} B, lossless")
    print("ok")


if __name__ == "__main__":
    main()

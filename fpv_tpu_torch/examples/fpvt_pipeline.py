"""FPVT profile on the port: the batched device codec, timestamps,
previews, frame-granular random access and byte accounting.

The counterpart of the JAX package's ``examples/fpvt_pipeline.py``.  The
bytes equal the JAX writer's (held in tests/test_torch_file_api.py).

    python -m fpv_tpu_torch.examples.fpvt_pipeline [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np

from fpv_tpu_torch.api.fpvt_codec import (
    FpvtReader,
    decode_file_fpvt,
    encode_file_fpvt,
)
from fpv_tpu_torch.cli.inspect import format_report, inspect_bytes
from fpv_tpu_torch.utils import testdata
from fpv_tpu_torch.utils.platform import argv_device


def main(argv: list[str] | None = None) -> None:
    _argv, device = argv_device(argv, "fpvt_pipeline")
    frames = testdata.plasma_frames(16, 128, 160, bits=12, seed=3)
    ts = 1_000_000 + 40_000 * np.arange(16, dtype=np.int64)  # 25 kfps

    data = encode_file_fpvt(frames, shift=4, frames_per_batch=8,
                            timestamps=ts, device=device)
    print(f"FPVT: {8 * len(data) / frames.size:.3f} bpp")

    # lossless roundtrip (left-aligned values, like the reference library)
    out = decode_file_fpvt(data, device=device)
    assert (out == (frames.astype(np.uint16) << 4)).all()

    r = FpvtReader(data, device=device)
    # one frame decodes from only its covering rANS blocks
    f5 = r.decode_frame(5)
    pv5 = r.preview_frame(5)
    assert (f5 == out[5]).all()
    print(f"frame 5: {f5.shape} u16, preview {pv5.shape} u8")
    # timestamps ride in the batch sections (frame 0 doubles as the
    # delta frame, so its section starts at frame 1)
    print("timestamps batch 0:", r.timestamps(0))
    assert (r.timestamps(0) == ts[1:9]).all()

    # where every byte goes (tables / states / counts / payload)
    print(format_report(inspect_bytes(data)))


if __name__ == "__main__":
    main()

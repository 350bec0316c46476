"""Multi-device scaling on the port: whole FPVT files encoded and decoded
data-parallel over a mesh of devices.

The counterpart of the JAX package's ``examples/multichip.py``.  Each
mesh-size group of batches runs one batch per data shard; the file is
byte-identical to the single-device writer's.  On cards the mesh takes
every visible card (up to 4); on the CPU (``--device cpu``) four logical
shards of the CPU device.  As the JAX script pins its fused regime, the
script writes every batch in the fused 1024-lane geometry (the narrow
small-file policy off), on both sides of the comparison.

    python -m fpv_tpu_torch.examples.multichip [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from fpv_tpu_torch.api.fpvt_codec import encode_file_fpvt
from fpv_tpu_torch.entropy import plane_codec
from fpv_tpu_torch.parallel import mesh as pmesh
from fpv_tpu_torch.utils import testdata
from fpv_tpu_torch.utils.platform import argv_device


def main(argv: list[str] | None = None) -> None:
    _argv, device = argv_device(argv, "multichip")
    plane_codec.NARROW_MAX_SYMS = 0  # the fused geometry, as in JAX's script
    if device.type == "cuda":
        ndev = min(torch.cuda.device_count(), 4)
        m = pmesh.make_mesh(ndev, data=ndev)
    else:
        ndev = 4
        m = pmesh.make_mesh(ndev, data=ndev, devices=[device] * ndev)
    print(f"mesh: {ndev} x {device.type}")

    # two full mesh groups plus a tail, at tiny frames and chunks (use
    # production sizes on cards: 1024x1024, frames_per_batch=16,
    # chunk_log2=12)
    n = 1 + 2 * ndev * 2 + 2
    frames = testdata.plasma_frames(n, 16, 16, bits=12, seed=1)

    kw = dict(shift=4, frames_per_batch=2, chunk_log2=4)
    sharded = pmesh.sharded_encode_file(frames, m, **kw)
    single = encode_file_fpvt(frames, device=m.devices[0][0], **kw)
    assert sharded == single, "sharded writer is byte-identical"

    out = pmesh.sharded_decode_file(sharded, m)
    assert (out == (frames.astype(np.uint16) << 4)).all()
    print(f"{n} frames, {len(sharded)} bytes: sharded encode byte-identical,"
          " sharded decode lossless")


if __name__ == "__main__":
    main()

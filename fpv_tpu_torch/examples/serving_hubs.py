"""Many-camera serving on the port: independent streams multiplexed onto
the device.

The counterpart of the JAX package's ``examples/serving_hubs.py``.
MultiStreamEncoder batches each stream's frames and encodes full batches
on the device; MultiStreamDecoder is its twin, with an issue/finalize
pipeline so downloads overlap uploads and kernels.  Both take
``devices=[...]`` to spread streams round-robin over cards.

    python -m fpv_tpu_torch.examples.serving_hubs [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np

from fpv_tpu_torch.api.multistream import (
    MultiStreamDecoder,
    MultiStreamEncoder,
)
from fpv_tpu_torch.utils import testdata
from fpv_tpu_torch.utils.platform import argv_device


def main(argv: list[str] | None = None) -> None:
    _argv, device = argv_device(argv, "serving_hubs")
    cams = {f"cam{i}": testdata.plasma_frames(9, 64, 64, seed=i)
            for i in range(3)}

    # encode side: the sink receives each stream's byte chunks in order
    files: dict[str, list] = {sid: [] for sid in cams}
    enc = MultiStreamEncoder(64, 64, shift=4, frames_per_batch=4,
                             sink=lambda sid, b: files[sid].append(b),
                             devices=[device])
    for sid, fr in cams.items():
        enc.add_stream(sid, fr[0])  # first frame = prediction base
    for i in range(9):  # interleaved arrival, like real cameras
        for sid, fr in cams.items():
            enc.push_frame(sid, timestamp=1000 + i, frame=fr[i])
    enc.close()

    # decode side: feed chunks in any interleaving
    got: dict[str, list] = {sid: [] for sid in cams}
    dec = MultiStreamDecoder(sink=lambda sid, imgs, ts: got[sid].append(imgs),
                             devices=[device])
    for sid in cams:
        dec.add_stream(sid)
    for sid in cams:
        for chunk in files[sid]:
            dec.feed(sid, chunk)
    dec.close()

    for sid, fr in cams.items():
        out = np.concatenate(got[sid])
        want = fr.astype(np.uint16) << 4
        assert (out == want).all(), sid
    print(f"{len(cams)} streams served losslessly, per-stream ordered")


if __name__ == "__main__":
    main()

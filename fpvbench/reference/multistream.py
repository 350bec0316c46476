"""Plain demultiplexer of many FPVT byte streams: the yardstick of a hub
that decodes camera streams fed in chunks.

The contract of such a hub: whatever the chunking and the interleaving of
the streams' bytes, each stream gets its frames once, in order, lossless.
So the plain answer is to join each stream's chunks in the order they came
and decode each whole file with :mod:`fpvbench.reference.fpvt`.  NumPy and
plain PyTorch only; nothing of the codec under test is imported.

    got = decode([("cam0", b"..."), ("cam1", b"..."), ("cam0", b"...")])
    frames, timestamps = got["cam0"]   # int32 [N, H, W], i64 [N]
"""

from __future__ import annotations

import numpy as np

from fpvbench.reference import fpvt

# the timestamp of a frame the file stores none for: frame 0 of a file
# whose delta section is its first frame
NO_TIMESTAMP = -1


def join(chunks) -> dict:
    """``(stream_id, bytes)`` chunks in any order and of any sizes ->
    stream id -> the stream's bytes, joined in the order they came."""
    parts: dict = {}
    for sid, data in chunks:
        parts.setdefault(sid, []).append(bytes(data))
    return {sid: b"".join(p) for sid, p in parts.items()}


def timestamps(f: fpvt.File) -> np.ndarray:
    """Every frame's i64 timestamp in file order (frame 0 of a file whose
    delta section is its first frame: :data:`NO_TIMESTAMP`)."""
    first = [np.full(1, NO_TIMESTAMP, np.int64)] if f.delta_is_frame0 else []
    return np.concatenate(first + [b.timestamps.astype(np.int64)
                                   for b in f.batches]
                          + [np.zeros(0, np.int64)])


def decode(chunks, device="cpu") -> dict:
    """Stream id -> ``(frames, timestamps)`` of every stream in ``chunks``:
    frames int32 [N, H, W] (left-aligned u16 values) on ``device``,
    timestamps i64 [N] on the host.  Raises :class:`fpvt.FormatError`
    when a stream is no whole file or a rANS stream fails its check."""
    files = {sid: fpvt.parse(data) for sid, data in join(chunks).items()}
    decoded = fpvt.decode_files(list(files.values()), device)
    out = {}
    for (sid, f), dec in zip(files.items(), decoded):
        if dec.faults:
            raise fpvt.FormatError(
                f"stream {sid!r}: {dec.faults} rANS integrity checks failed")
        out[sid] = (dec.frames, timestamps(f))
    return out


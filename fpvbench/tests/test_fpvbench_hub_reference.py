"""The plain demultiplexer (``reference/multistream.py``) against the plain
FPVT reader on whole files, on the CPU at a small size; and, on the card,
one shot of the ``cam12_1mp_x4`` configuration through the program's hub
against the demultiplexer and the recordings."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fpvbench import frames as framegen, harness
from fpvbench.reference import fpvt as ref
from fpvbench.reference import multistream as demux


def _files(n_streams, n, h, w, device, fpb=4, chunk_log2=6, seed=11):
    """Recordings of 12-bit streams and their files, written by the
    program on ``device``."""
    import fpv_tpu_torch

    recs = {}
    for i, s in enumerate(framegen.recording_seeds(seed, n_streams)):
        recs[f"cam{i}"] = framegen.to_host(
            framegen.plasma(n, h, w, 12, 6, s, device))
    files = {sid: fpv_tpu_torch.encode_file_fpvt(
        r, shift=4, frames_per_batch=fpb, chunk_log2=chunk_log2,
        device=device) for sid, r in recs.items()}
    return recs, files


def _round_robin(files: dict, size: int) -> list:
    """Every stream's ``size``-byte chunks, one a stream in turn."""
    out = []
    for off in range(0, max(len(d) for d in files.values()), size):
        out += [(sid, memoryview(d)[off : off + size])
                for sid, d in files.items() if off < len(d)]
    return out


@pytest.fixture(scope="module")
def small():
    return _files(3, 9, 32, 64, "cpu")


@pytest.mark.parametrize("size", [1, 29, 1 << 20])
def test_demultiplexer_equals_the_reader_on_whole_files(small, size):
    recs, files = small
    chunks = _round_robin(files, size)
    rng = np.random.default_rng(size)
    shuffled = [chunks[i] for i in rng.permutation(len(chunks))]
    # the same chunks in another interleaving: each stream's own order kept
    by_stream = {sid: [c for c in chunks if c[0] == sid] for sid in files}
    mixed = [by_stream[sid].pop(0) for sid, _c in shuffled]
    assert demux.join(chunks) == demux.join(mixed) == files
    got = demux.decode(mixed)
    for sid, data in files.items():
        f = ref.parse(data)
        want = ref.decode(f)
        frames, stamps = got[sid]
        assert torch.equal(frames, want.frames)
        assert torch.equal(frames, ref.left_aligned(
            torch.from_numpy(recs[sid].astype(np.int32)), 4))
        assert stamps.tolist() == [demux.NO_TIMESTAMP] + [
            t for b in f.batches for t in b.timestamps.tolist()]


def test_demultiplexer_refuses_a_stream_cut_short(small):
    _recs, files = small
    chunks = _round_robin(files, 1000)
    with pytest.raises(ref.FormatError):
        demux.decode(chunks[:-1])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the cell runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_shot_of_the_cell_equals_the_reference_on_the_card(card):
    """One shot of ``cam12_1mp_x4`` at its size (four 128-frame 1 MP
    12-bit files, 1 MiB chunks round-robin, each stream ended): the hub's
    frames and timestamps equal the demultiplexer's, decoded on the card,
    and the recordings, exactly."""
    import fpv_tpu_torch

    bench = harness.load_benchmark()
    cfg = harness.load_config(bench, "cam12_1mp_x4")
    mix = harness.load_traffic("replay_hub")
    recs, files = _files(cfg["streams"], cfg["frames_per_recording"],
                         cfg["height"], cfg["width"], card,
                         cfg["frames_per_batch"], cfg["chunk_log2"])
    chunks = _round_robin(files, mix["chunk_bytes"])
    got = {sid: ([], []) for sid in files}

    def sink(sid, frames, ts):
        got[sid][0].append(frames.copy())
        got[sid][1].append(ts)

    hub = fpv_tpu_torch.MultiStreamDecoder(sink=sink, devices=[card])
    for sid in files:
        hub.add_stream(sid)
    for sid, piece in chunks:
        hub.feed(sid, piece)
    for sid in files:
        hub.end_stream(sid)
    hub.close()
    want = demux.decode(chunks, card)
    for sid, (frames, stamps) in want.items():
        hub_frames = np.concatenate(got[sid][0])
        assert np.array_equal(hub_frames.astype(np.int32),
                              frames.cpu().numpy())
        assert np.array_equal(np.concatenate(got[sid][1]), stamps)
        assert np.array_equal(hub_frames, recs[sid] << np.uint16(4))

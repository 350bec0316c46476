"""The port's default FPVT file API against the JAX package's defaults.

Writer: ``fpv_tpu_torch.encode_file_fpvt`` must write the bytes JAX's
``encode_file_fpvt`` writes with its defaults (numpy engine on the CPU,
narrow-stream policy on, no env knobs): narrow ctx16 and order-0 streams,
uint8 frames, an explicit delta frame, timestamps, frames without a
preview stream, constant and stored planes, and both sides of the
narrow-policy boundary.  Reader: random access, previews, timestamps, the
delta frame, streaming and uint8 decode must give what JAX's reader gives,
on those files and on a wide file whose frames span several rANS blocks.
The golden fixtures are held in test_torch_golden.py.
"""

import numpy as np
import pytest

from fpv_tpu.api import fpvt_codec as jcodec
from fpv_tpu.utils import testdata
import fpv_tpu_torch
from fpv_tpu_torch.api import fpvt_codec as tcodec
from fpv_tpu_torch.entropy import plane_codec as tpc
from fpv_tpu_torch.format import fpvt as tfpvt
from fpv_tpu_torch.ops.rans_layout import BLOCK_LANES, CODING_CONST, CODING_RAW


def _drift_frames(n, h, w):
    """Frame t is frame 0 translated: prev-frame prediction wins."""
    pl = testdata.plasma_frames(1, h, w, bits=12, seed=3)[0]
    return np.stack(
        [np.roll(pl, (2 * i, 3 * i), (0, 1)) for i in range(n)]
    ).astype(np.uint16)


_PLASMA = testdata.plasma_frames(7, 40, 56, bits=12, seed=7)
ENC = dict(frames_per_batch=3, chunk_log2=8)

# name -> (frames, encode kwargs, left-aligned decode of the file)
CASES = {
    "plasma-ctx16": (_PLASMA, dict(shift=4), _PLASMA << 4),
    "plasma16-order0": (testdata.plasma_frames(7, 40, 56, bits=16, seed=8),
                        dict(shift=0), None),
    "uint8": ((_PLASMA >> 4).astype(np.uint8), {},
              (_PLASMA >> 4).astype(np.uint16) << 8),
    "delta-frame": (_PLASMA[1:], dict(shift=4, delta_frame=_PLASMA[0]),
                    _PLASMA[1:] << 4),
    "timestamps": (_PLASMA, dict(shift=4, timestamps=np.arange(7) * 1000 + 3),
                   _PLASMA << 4),
    "tiny-3x3": (testdata.plasma_frames(5, 3, 3, bits=12, seed=2),
                 dict(shift=4), None),
    "drift-prev": (_drift_frames(12, 48, 64),
                   dict(shift=4, frames_per_batch=10), None),
    "repeated-const": (np.repeat(_PLASMA[:1], 5, axis=0), dict(shift=4), None),
    "noise-raw": (testdata.noise_frames(4, 24, 32), dict(shift=0), None),
}


@pytest.fixture(scope="module")
def files():
    """name -> (frames, JAX bytes, port bytes, expected decode)."""
    out = {}
    for name, (frames, kw, want) in CASES.items():
        kw = {**ENC, **kw}
        jax_bytes = jcodec.encode_file_fpvt(frames, **kw)
        port = fpv_tpu_torch.encode_file_fpvt(frames, device="cpu", **kw)
        if want is None:
            want = frames << kw["shift"]
        out[name] = (frames, jax_bytes, port, want)
    return out


def _codings(data: bytes) -> set:
    out = set()
    for off, _n in tfpvt.parse_footer(data):
        pb = tfpvt.parse_batch_section(data, off)
        out |= {(st.coding, st.lanes) for st in (pb.high, pb.low, pb.preview)
                if st is not None}
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_port_bytes_equal_jax_default_writer(files, name):
    _frames, jax_bytes, port, want = files[name]
    assert port == jax_bytes
    got = fpv_tpu_torch.decode_file_fpvt(port, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_writer_cases_cover_the_policy(files):
    """The cases reach narrow coded streams, const and raw streams, and a
    file without preview streams."""
    codings = set().union(*(_codings(f[2]) for f in files.values()))
    for coding in (0, 1):
        assert any(c == coding and 0 < lanes < BLOCK_LANES
                   for c, lanes in codings)
    assert any(c == CODING_CONST for c, _ in codings)
    assert any(c == CODING_RAW for c, _ in codings)
    data = files["tiny-3x3"][2]
    off, _n = tfpvt.parse_footer(data)[0]
    assert tfpvt.parse_batch_section(data, off).preview is None


@pytest.mark.parametrize("over", [False, True], ids=["at", "over"])
def test_narrow_policy_boundary(monkeypatch, over):
    """A body of exactly NARROW_MAX_SYMS symbols is written narrow; one more
    frame's worth takes the fused 1024-lane route (the JAX device writer's,
    so the JAX side runs its pallas engine there).  The boundary is lowered
    so both sides stay small."""
    frames = testdata.plasma_frames(3 if over else 2, 96, 112, bits=12,
                                    seed=11)
    limit = 96 * 112
    monkeypatch.setenv("FPV_TPU_NARROW_MAX", str(limit))
    if over:
        monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "pallas")
    monkeypatch.setattr(tpc, "NARROW_MAX_SYMS", limit)
    kw = dict(shift=4, frames_per_batch=2, chunk_log2=4)
    port = fpv_tpu_torch.encode_file_fpvt(frames, device="cpu", **kw)
    assert port == jcodec.encode_file_fpvt(frames, **kw)
    lanes = {lanes for _c, lanes in _codings(port) if lanes}
    assert lanes == ({BLOCK_LANES} if over else {8})


def test_plane_ingest_equals_frame_ingest():
    frames = testdata.plasma_frames(5, 24, 40, bits=16, seed=9)
    high, low = (frames >> 8).astype(np.uint8), (frames & 0xFF).astype(
        np.uint8)
    out = []
    for planes in (False, True):
        wri = fpv_tpu_torch.FpvtWriter(40, 24, frames_per_batch=2,
                                       chunk_log2=8, device="cpu")
        if planes:
            parts = [wri.init_planes(high[0], low[0])]
            parts += [wri.encode_batch_planes(high[s : s + 2], low[s : s + 2])
                      for s in (1, 3)]
        else:
            parts = [wri.init(frames[0])]
            parts += [wri.encode_batch(frames[s : s + 2]) for s in (1, 3)]
        out.append(b"".join(parts + [wri.finish()]))
    assert out[0] == out[1]


@pytest.fixture(scope="module")
def wide_file():
    """A file whose frames span several rANS blocks (1024 lanes, chunk 16:
    16 Ki symbols per block, 20 Ki pixels per frame) with prev chains."""
    frames = _drift_frames(9, 128, 160)
    wri = fpv_tpu_torch.FpvtWriter(160, 128, 4, False, 8, 4, device="cpu",
                                   delta_is_frame0=True, narrow=False)
    parts = [wri.init(frames[0]), wri.encode_batch(frames[1:])]
    data = b"".join(parts + [wri.finish()])
    return data, jcodec.decode_file_fpvt(data)


def _file(files, wide_file, name):
    """The bytes of a writer case (JAX's) or of the wide file (the port's)."""
    return wide_file[0] if name == "wide" else files[name][1]


@pytest.mark.parametrize("name", ["drift-prev", "plasma-ctx16", "wide"])
def test_decode_frame_equals_jax_decode(files, wide_file, name):
    """Every frame, forward and then in reverse order (the chain cache
    serves mid-chain frames), equals JAX's whole-file decode."""
    data = _file(files, wide_file, name)
    want = jcodec.decode_file_fpvt(data)
    r = fpv_tpu_torch.FpvtReader(data, device="cpu")
    assert r.numframes == len(want)
    order = list(range(r.numframes))
    for i in order + order[::-1]:
        np.testing.assert_array_equal(r.decode_frame(i), want[i], str(i))
    prev_mid = [
        j for bi in range(r.num_batches)
        for j, f in enumerate(r._parse_batch(r._batches[bi][0]).frame_flags)
        if f & tfpvt.F_USE_PREV and j > 1
    ]
    assert prev_mid or name == "plasma-ctx16"


def _spy(monkeypatch, name):
    """Record the calls to plane_codec's ``name`` (``stage_blocks``'s jobs
    as (name, b0, b1), ``launch_blocks``' as the jobs launched)."""
    seen = []
    real = getattr(tpc, name)

    def spy(jobs, arg):
        seen.append([(n, b0, b1) for n, _st, b0, b1 in jobs]
                    if name == "stage_blocks" else list(arg))
        return real(jobs, arg)

    monkeypatch.setattr(tpc, name, spy)
    return seen


def _chain_start(r, index):
    """(batch, first frame decoded, frame) of ``decode_frame(index)`` on
    reader ``r`` as it stands: the prev chain's anchor, or the frame after
    the chain cache's when that one is earlier in the same chain."""
    bi, j = r._frame_to_batch[index]
    flags = r._parse_batch(r._batches[bi][0]).frame_flags
    j0 = j
    while j0 > 0 and flags[j0] & tfpvt.F_USE_PREV:
        j0 -= 1
    cc = r._chain_cache
    if cc is not None and cc[0] == bi and j0 <= cc[1] < j:
        return bi, cc[1] + 1, j
    return bi, j0, j


def test_decode_frame_reads_only_covering_blocks(wide_file, monkeypatch):
    """Each random access on the wide file stages its whole prev chain
    once: one staging call, high and low together, whose blocks a plane
    are exactly the union of the chain frames' covering blocks (each
    block once), not the batch's ten."""
    data, want = wide_file
    seen = _spy(monkeypatch, "stage_blocks")
    r = fpv_tpu_torch.FpvtReader(data, device="cpu")
    s = r.header.ysize * r.header.xsize
    walked = 0
    for i in list(range(1, r.numframes)) + [5, 2, 7]:
        bi, t0, j = _chain_start(r, i)
        seen.clear()  # the delta section's planes, the last request's
        np.testing.assert_array_equal(r.decode_frame(i), want[i], str(i))
        pb = r._parse_batch(r._batches[bi][0])
        span = pb.high.chunk_len * pb.high.lanes
        cover = (t0 * s // span, ((j + 1) * s - 1) // span)
        assert seen == [[("high", *cover), ("low", *cover)]], (i, seen)
        assert cover[1] - cover[0] < pb.high.num_blocks
        walked += j - t0
    assert walked  # some request walked a chain of several frames


@pytest.mark.parametrize("order", ["forward", "reverse", "continue"])
def test_decode_frame_one_launch_per_chain(wide_file, monkeypatch, order):
    """Every frame of the wide file decodes with one staging call and one
    K2 launch (``launch_blocks``) for its whole prev chain, high and low
    planes together: in forward order (each request continues the chain
    cache), in reverse order (each walks from the anchor), and for a
    request that continues the chain cache from a frame past the anchor.
    Frame 0, the delta frame, launches nothing."""
    data, want = wide_file
    staged = _spy(monkeypatch, "stage_blocks")
    launched = _spy(monkeypatch, "launch_blocks")
    r = fpv_tpu_torch.FpvtReader(data, device="cpu")
    n = r.numframes
    frames = {"forward": list(range(n)), "reverse": list(range(n))[::-1],
              "continue": [2, 6]}[order]
    starts = []
    for i in frames:
        _bi, t0, j = _chain_start(r, i)
        staged.clear()
        launched.clear()
        np.testing.assert_array_equal(r.decode_frame(i), want[i], str(i))
        calls = 0 if r._frame_to_batch[i][0] == -1 else 1
        assert (len(staged), len(launched)) == (calls, calls), i
        assert all(jobs == [0, 1] for jobs in launched), launched
        starts.append(t0)
    if order == "continue":
        # frame 6 (batch frame 5) continues frame 2's chain (batch frames
        # 0..1): it decodes batch frames 2..5 alone
        assert starts == [0, 2]


@pytest.mark.parametrize("plane", ["high", "low", "preview"])
def test_flipped_payload_word_raises_as_the_batch_does(wide_file, plane):
    """A payload word flipped inside the rANS block where a chain frame
    starts makes ``decode_frame`` of that frame raise the ValueError
    (naming the plane) that ``decode_batch`` of its batch raises; a
    flipped preview word makes ``decode_previews`` raise as
    ``decode_batch_with_previews`` does."""
    from fpv_tpu_torch.ops.rans_layout import num_segments

    data = wide_file[0]
    r = fpv_tpu_torch.FpvtReader(data, device="cpu")
    index = 6
    bi, j = r._frame_to_batch[index]
    pb = r._parse_batch(r._batches[bi][0])
    assert j and pb.frame_flags[j] & tfpvt.F_USE_PREV  # a chain to walk
    st = getattr(pb, plane)
    assert st.coding not in (CODING_CONST, CODING_RAW)
    assert st.lanes == BLOCK_LANES
    b0 = (0 if plane == "preview"
          else j * st.plane_size // (st.chunk_len * st.lanes))
    nseg = num_segments(st.chunk_len)
    cum = np.concatenate([[0], np.cumsum(st.block_counts.astype(np.int64))])
    word = (cum[b0 * nseg] + cum[(b0 + 1) * nseg]) // 2
    pos = data.index(st.payload.tobytes()) + 2 * int(word)
    bad = bytearray(data)
    bad[pos : pos + 2] = bytes(x ^ 0x5A for x in bad[pos : pos + 2])
    whole, one = ((tcodec.FpvtReader.decode_batch_with_previews,
                   tcodec.FpvtReader.decode_previews) if plane == "preview"
                  else (tcodec.FpvtReader.decode_batch,
                        lambda rd, _bi: rd.decode_frame(index)))
    errors = []
    for fn in (whole, one):
        with pytest.raises(ValueError,
                           match=rf"integrity.*\({plane} plane\)") as e:
            fn(fpv_tpu_torch.FpvtReader(bytes(bad), device="cpu"), bi)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("name", ["drift-prev", "plasma-ctx16", "tiny-3x3",
                                  "timestamps", "wide"])
def test_previews_timestamps_delta_equal_jax(files, wide_file, name):
    data = _file(files, wide_file, name)
    jr = jcodec.FpvtReader(data)
    tr = fpv_tpu_torch.FpvtReader(data, device="cpu")
    np.testing.assert_array_equal(tr.delta_frame(), jr.delta_frame())
    for bi in range(jr.num_batches):
        np.testing.assert_array_equal(tr.timestamps(bi), jr.timestamps(bi))
        np.testing.assert_array_equal(tr.decode_previews(bi),
                                      jr.decode_previews(bi))
        for got, ref in zip(tr.decode_batch_with_previews(bi),
                            jr.decode_batch_with_previews(bi)):
            np.testing.assert_array_equal(got, ref)
    for i in range(jr.numframes):
        np.testing.assert_array_equal(tr.preview_frame(i),
                                      jr.preview_frame(i))


@pytest.mark.parametrize("name,piece", [("timestamps", 1), ("timestamps", 7),
                                        ("timestamps", 4096), ("wide", 4096)])
def test_streaming_reader_equals_jax(files, wide_file, name, piece):
    data = _file(files, wide_file, name)
    ref, got = [], []
    jr = jcodec.FpvtStreamingReader(lambda *a: ref.append(a),
                                    want_previews=True)
    jr.decode(data)
    tr = tcodec.FpvtStreamingReader(lambda *a: got.append(a),
                                    want_previews=True, device="cpu")
    for s in range(0, len(data), piece):
        tr.decode(data[s : s + piece])
    assert len(got) == len(ref) == 1 + jcodec.FpvtReader(data).num_batches
    for g, r in zip(got, ref):
        assert len(g) == 3
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, np.asarray(b))
    no_pv = []
    tcodec.FpvtStreamingReader(lambda *a: no_pv.append(a),
                               device="cpu").decode(data)
    assert [len(a) for a in no_pv] == [2] * len(ref)


def test_decode_uint8(files):
    frames, _j, port, _want = files["uint8"]
    np.testing.assert_array_equal(
        fpv_tpu_torch.decode_file_fpvt(port, dtype=np.uint8, device="cpu"),
        frames)
    with pytest.raises(ValueError, match="shift=8"):
        fpv_tpu_torch.decode_file_fpvt(files["plasma-ctx16"][2],
                                       dtype=np.uint8, device="cpu")


def _assembled(data: bytes, dtype) -> np.ndarray:
    """A whole-file decode put together from the reader's parts: frame 0
    and every batch's ``decode_batch``, concatenated."""
    r = fpv_tpu_torch.FpvtReader(data, device="cpu")
    parts = [r.frame0()[None]] if r.header.delta_is_frame0 else []
    parts += [r.decode_batch(i) for i in range(r.num_batches)]
    h, w = r.header.ysize, r.header.xsize
    out = np.concatenate(parts) if parts else np.zeros((0, h, w), np.uint16)
    return (out >> 8).astype(np.uint8) if dtype == np.uint8 else out


_NO_BATCH = {
    # frame 0 alone: the delta section and no batch section
    "frame0-only": dict(frames=_PLASMA[:1]),
    # an explicit delta frame and no frames at all
    "no-frames": dict(frames=_PLASMA[:0], delta_frame=_PLASMA[0]),
}


@pytest.mark.parametrize("cap", [None, 1], ids=["cap", "over-cap"])
@pytest.mark.parametrize("name", [
    "plasma-ctx16",  # 12-bit, ctx16 low plane
    "plasma16-order0",  # 16-bit, order-0 low plane
    "drift-prev",  # batches of 10 and a partial one of 1
    "delta-frame",  # an explicit delta frame: no frame 0 to download
    "uint8",  # the uint8 return path
    "wide",  # 1024-lane streams
    *_NO_BATCH,
])
def test_decode_file_writes_one_output(files, wide_file, monkeypatch, name,
                                       cap):
    """decode_file_fpvt downloads each batch into its slice of one output:
    the bytes are what the reader's parts give concatenated (and JAX's
    decode), in a C-contiguous array the caller may write to; on the CPU
    the output is pageable, under or over the pinned cap."""
    dtype = np.uint8 if name == "uint8" else np.uint16
    if name in _NO_BATCH:
        kw = dict(_NO_BATCH[name])
        data = fpv_tpu_torch.encode_file_fpvt(kw.pop("frames"), shift=4,
                                              device="cpu", **ENC, **kw)
        assert tfpvt.parse_footer(data) == []
    elif name == "wide":
        data = wide_file[0]
    else:
        data = files[name][2]
    if cap is not None:
        monkeypatch.setattr(tcodec, "PINNED_OUTPUT_MAX_BYTES", cap)
    want = _assembled(data, dtype)
    before = dict(tcodec.DECODE_FILE_OUTPUTS)
    got = fpv_tpu_torch.decode_file_fpvt(data, dtype=dtype, device="cpu")
    assert tcodec.DECODE_FILE_OUTPUTS == {
        "pinned": before["pinned"], "pageable": before["pageable"] + 1}
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    if len(want):
        np.testing.assert_array_equal(
            got, jcodec.decode_file_fpvt(data, dtype=dtype))
    assert got.flags.c_contiguous and got.flags.writeable
    got[...] = 1
    again = fpv_tpu_torch.decode_file_fpvt(data, dtype=dtype, device="cpu")
    assert again.tobytes() == want.tobytes()
    assert (got == 1).all()


def test_writer_rejects_oversize_device_batch():
    """1 frame x 65536^2 = 2^32 symbols exceeds MAX_DEVICE_SYMS: the guard
    fires before any real frame data is touched (the kernels' int32 word
    offsets would otherwise wrap)."""
    w = fpv_tpu_torch.FpvtWriter(65536, 65536, frames_per_batch=1,
                                 device="cpu")
    w._delta_high = w._delta_low = object()  # skip init for the guard test
    with pytest.raises(ValueError, match="2\\^31 symbols"):
        # only .shape[0] is read before the guard; a tiny stand-in array
        # exercises the check without 8 GB of frames
        w.encode_batch_bytes(np.zeros((1, 4, 4), np.uint16))


def test_reader_rejects_oversize_device_batch(files):
    """A batch of 2^32 constant symbols is refused before the 4 GB plane
    would be allocated."""
    r = fpv_tpu_torch.FpvtReader(files["plasma-ctx16"][2], device="cpu")
    big = tpc.const_plane_stream(1, 65536 * 65536, 256, 0)
    pb = tfpvt.ParsedBatch(frame_flags=np.zeros(1, np.uint8),
                           timestamps=np.full(1, -1, np.int64), high=big,
                           low=big, preview=None)
    with pytest.raises(ValueError, match="2\\^31 symbols"):
        r._issue(pb)


# malformed input: the JAX suite's tests (tests/test_fpvt.py) on the port,
# with the same seeds and counts; every failure must be a ValueError


def test_malformed_inputs_rejected():
    import struct

    with pytest.raises(ValueError):
        fpv_tpu_torch.FpvtReader(b"NOPE" + b"\0" * 60, device="cpu")
    with pytest.raises(ValueError):
        tfpvt.Header.parse(b"FPVT" + b"\0" * 10)  # too small
    # oversized dims
    bad = struct.pack("<4sBBHIIBBHIQ", b"FPVT", 1, 1, 0, 70000, 70000, 0, 9,
                      0, 16, 0)
    with pytest.raises(ValueError):
        tfpvt.Header.parse(bad)
    # valid header but garbage body
    good = tfpvt.Header(xsize=32, ysize=32).serialize()
    with pytest.raises(ValueError):
        fpv_tpu_torch.FpvtReader(good + b"\0" * 64, device="cpu")


def _fuzz_file() -> bytes:
    frames = testdata.plasma_frames(4, 16, 16)
    data = fpv_tpu_torch.encode_file_fpvt(frames, frames_per_batch=2,
                                          chunk_log2=4, device="cpu")
    assert data == jcodec.encode_file_fpvt(frames, frames_per_batch=2,
                                           chunk_log2=4)
    return data


def test_fuzz_single_byte_mutations():
    """Single-byte mutations either still decode or raise ValueError."""
    data = bytearray(_fuzz_file())
    rng = np.random.default_rng(7)
    for _ in range(150):
        i = int(rng.integers(0, len(data)))
        old = data[i]
        data[i] ^= int(rng.integers(1, 256))
        try:
            fpv_tpu_torch.decode_file_fpvt(bytes(data), device="cpu")
        except ValueError:
            pass
        finally:
            data[i] = old


def test_fuzz_truncations():
    data = _fuzz_file()
    rng = np.random.default_rng(8)
    cuts = sorted(set(int(c) for c in rng.integers(0, len(data), 40)))
    for cut in cuts:
        try:
            fpv_tpu_torch.decode_file_fpvt(data[:cut], device="cpu")
        except ValueError:
            pass


@pytest.mark.parametrize("pos,flip,claimed", [(2431, 4, 67_108_865),
                                              (2430, 168, 11_010_049)])
def test_footer_frame_count_checked_at_open(pos, flip, claimed):
    """A footer entry whose frame count differs from its batch section's
    is refused when the port's reader opens the file.  A deliberate
    divergence: the JAX reader takes the footer's counts as they are (its
    numframes would be 1 + the claimed counts; computed here from its
    footer parse, not by building its frame index of millions of
    entries)."""
    from fpv_tpu.format import fpvt as jfpvt

    data = bytearray(_fuzz_file())
    assert len(data) == 2448
    data[pos] ^= flip
    data = bytes(data)
    counts = [n for _off, n in jfpvt.parse_footer(data)]
    assert claimed in counts
    assert 1 + sum(counts) == claimed + 3
    with pytest.raises(ValueError, match=f"footer claims {claimed} frames"):
        fpv_tpu_torch.FpvtReader(data, device="cpu")
    with pytest.raises(ValueError, match="footer"):
        fpv_tpu_torch.decode_file_fpvt(data, device="cpu")

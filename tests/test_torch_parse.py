"""The port's FPVT parse: read-only views of a read-only buffer, copies of
a writable one.

``format/fpvt.py`` parses ``bytes`` or a read-only memoryview into views of
its bytes (payload, states, block counts, the order-0 table, frame flags and
timestamps) and a ``bytearray`` or writable ``memoryview`` into copies,
and counts the coded and RAW plane streams of each kind in
``PARSED_STREAMS``.  The
files cover RAW, CONST, order-0 and ctx16 streams, narrow and 1024-lane,
batches of odd and even frame counts (so unaligned arrays), odd RAW sizes
and the golden fixtures; their decodes are held to the JAX package's
reader and to ``tests/golden/``.  Every check the parse makes must still
fail a crafted stream, from either kind of buffer.
"""

import pathlib
import struct

import numpy as np
import pytest
import torch

from fpv_tpu.api import fpvt_codec as jcodec
import fpv_tpu_torch
from fpv_tpu_torch.api import fpvt_codec as tcodec
from fpv_tpu_torch.format import fpvt as tfpvt
from fpv_tpu_torch.ops.rans_layout import (
    CODING_CONST,
    CODING_CTX16,
    CODING_ORDER0,
    CODING_RAW,
)
from fpv_tpu_torch.utils import testdata

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
GOLDEN_FILES = {"v4.fpvt": ("drift", 4), "v5.fpvt": ("drift", 4),
                "v6_drift.fpvt": ("drift", 4), "v6_raw.fpvt": ("noise16", 0)}
ENC = dict(device="cpu", chunk_log2=8)


def _mixed(n_plasma, n_noise, h, w):
    """12-bit plasma frames (coded order-0 high, ctx16 low), then noise
    (RAW high planes)."""
    pl = testdata.plasma_frames(n_plasma, h, w, bits=12, seed=5)
    nz = testdata.noise_frames(n_noise, h, w) >> 4
    return np.concatenate([pl, nz]).astype(np.uint16)


def _wide(frames, sizes, shift=4):
    """A 1024-lane file (chunk 16) with batches of ``sizes`` frames."""
    h, w = frames.shape[1:]
    wri = fpv_tpu_torch.FpvtWriter(w, h, shift, False, max(sizes), 4,
                                   device="cpu", delta_is_frame0=True,
                                   narrow=False)
    parts, s = [wri.init(frames[0])], 1
    for n in sizes:
        parts.append(wri.encode_batch(frames[s : s + n]))
        s += n
    return b"".join(parts + [wri.finish()])


def _make_files():
    """name -> file bytes, each written by the port."""
    return {
        # narrow order-0 / ctx16 / RAW streams, batches of 2
        "mixed-narrow": fpv_tpu_torch.encode_file_fpvt(
            _mixed(5, 4, 64, 96), shift=4, frames_per_batch=2, **ENC),
        # the same at 1024 lanes, batches of 3, 2 and 3
        "mixed-wide": _wide(_mixed(5, 4, 64, 96), [3, 2, 3]),
        # CONST streams, batches of 2 and 1
        "const": fpv_tpu_torch.encode_file_fpvt(
            np.repeat(testdata.plasma_frames(1, 32, 64, bits=12, seed=3), 4,
                      axis=0), shift=4, frames_per_batch=2, **ENC),
        # 16-bit: order-0 high plane, RAW low planes, batches of 3 and 1
        "order0-16bit": fpv_tpu_torch.encode_file_fpvt(
            testdata.plasma_frames(5, 64, 96, bits=16, seed=6),
            frames_per_batch=3, **ENC),
        # RAW planes of an odd size (3 x 9 x 15 bytes), padded on parse
        "noise-odd": fpv_tpu_torch.encode_file_fpvt(
            testdata.noise_frames(4, 9, 15), frames_per_batch=3, **ENC),
    }


FILES = _make_files()
NAMES = list(FILES) + list(GOLDEN_FILES)


def _data(name: str) -> bytes:
    if name in GOLDEN_FILES:
        return (GOLDEN / name).read_bytes()
    return FILES[name]


@pytest.fixture(scope="module")
def expected():
    """name -> the left-aligned frames the file holds: the golden inputs
    for a fixture, else JAX's decode of the port's file."""
    with np.load(GOLDEN / "inputs.npz") as z:
        inputs = {k: z[k] for k in z.files}
    out = {name: inputs[key] << shift
           for name, (key, shift) in GOLDEN_FILES.items()}
    out.update({name: jcodec.decode_file_fpvt(data)
                for name, data in FILES.items()})
    return out


def _buffer(data: bytes, kind: str):
    return {"bytes": data, "bytearray": bytearray(data),
            "memoryview": memoryview(bytearray(data)),
            "readonly": memoryview(bytearray(data)).toreadonly()}[kind]


def _parse_file(buf):
    """(every plane stream of the delta and batch sections, every batch's
    frame flags and timestamps), parsed from ``buf``."""
    hdr = tfpvt.Header.parse(buf)
    ps = hdr.ysize * hdr.xsize
    pvs = (hdr.ysize // 4) * (hdr.xsize // 4)
    _df, hs, ls = tfpvt.parse_delta_section(buf, tfpvt.HEADER_SIZE, ps)
    streams, small = [hs, ls], []
    for off, _n in tfpvt.parse_footer(bytes(buf)):
        pb = tfpvt.parse_batch_section(buf, off, ps, pvs)
        streams += [pb.high, pb.low, pb.preview]
        small += [pb.frame_flags, pb.timestamps]
    return [st for st in streams if st is not None], small


def _counted(streams) -> int:
    """The streams PARSED_STREAMS counts: coded and RAW."""
    return sum(st.coding != CODING_CONST for st in streams)


def _stream_arrays(st):
    """The arrays a stream's parse takes from the file's bytes (the ctx16
    table is derived, u8 -> u16, so it is always an array of its own)."""
    if st.coding == CODING_RAW:
        return [st.payload]
    if st.coding == CODING_CONST:
        return []
    out = [st.payload, st.states, st.block_counts]
    return out + ([st.freq] if st.coding == CODING_ORDER0 else [])


def _delta(before: dict) -> dict:
    return {k: tfpvt.PARSED_STREAMS[k] - before[k] for k in before}


@pytest.mark.parametrize("kind",
                         ["bytes", "bytearray", "memoryview", "readonly"])
@pytest.mark.parametrize("name", NAMES)
def test_parse_views_bytes_and_copies_mutable_buffers(name, kind):
    """From ``bytes`` or a read-only memoryview (of a bytearray: the
    streaming reader's case) every array the parse takes from the file
    shares its memory and is read-only (a RAW plane of odd size excepted:
    its pad makes it a copy); from a bytearray or writable memoryview each
    is a writable copy.  Both parses hold the same values, and the counter
    counts each coded or RAW stream once, under its kind."""
    data = _data(name)
    ref_streams, ref_small = _parse_file(bytearray(data))
    buf = _buffer(data, kind)
    base = np.frombuffer(buf, np.uint8)
    before = dict(tfpvt.PARSED_STREAMS)
    streams, small = _parse_file(buf)
    n = _counted(streams)
    assert n > 0
    viewed = kind in ("bytes", "readonly")
    assert _delta(before) == ({"view": n, "copy": 0} if viewed
                              else {"view": 0, "copy": n})
    codings = {st.coding for st in streams}
    for st, ref in zip(streams, ref_streams, strict=True):
        padded = st.coding == CODING_RAW and st.nframes * st.plane_size % 2
        for a in _stream_arrays(st):
            view = viewed and not padded
            assert np.shares_memory(a, base) == view
            assert a.flags.writeable != view
        if st.coding == CODING_CTX16:
            assert not np.shares_memory(st.freq, base)
        for field in ("payload", "states", "block_counts", "freq"):
            np.testing.assert_array_equal(getattr(st, field),
                                          getattr(ref, field))
        assert (st.coding, st.lanes, st.chunk_len) == (
            ref.coding, ref.lanes, ref.chunk_len)
    for a, ref in zip(small, ref_small, strict=True):
        assert np.shares_memory(a, base) == viewed
        np.testing.assert_array_equal(a, ref)
    if name == "mixed-narrow":
        assert {CODING_ORDER0, CODING_CTX16, CODING_RAW} <= codings
    if name == "const":
        assert CODING_CONST in codings
    if name == "noise-odd":
        assert any(st.coding == CODING_RAW and st.nframes * st.plane_size % 2
                   for st in streams)


def test_files_have_odd_and_even_batches_and_unaligned_payloads():
    """The files above hold batches of odd and even frame counts, and
    payload views that start at odd byte offsets."""
    sizes, offsets = set(), set()
    for data in FILES.values():
        streams, small = _parse_file(data)
        sizes |= {len(f) for f in small[::2]}
        base = np.frombuffer(data, np.uint8).__array_interface__["data"][0]
        offsets |= {(a.__array_interface__["data"][0] - base) % 2
                    for st in streams for a in _stream_arrays(st)}
    assert {1, 2, 3} <= sizes
    assert offsets == {0, 1}


@pytest.mark.parametrize("name", NAMES)
def test_views_and_copies_decode_pixel_exact(name, expected):
    """``decode_file_fpvt`` (a ``bytes`` reader: views), the streaming
    reader fed in uneven pieces (views of its buffer, read-only while a
    section is staged) and a reader's batches issued from a bytearray
    (copies) all give the golden inputs or JAX's decode, and count every
    stream under their kind."""
    data = _data(name)
    n = _counted(_parse_file(bytearray(data))[0])
    before = dict(tfpvt.PARSED_STREAMS)
    got = fpv_tpu_torch.decode_file_fpvt(data, device="cpu")
    assert _delta(before) == {"view": n, "copy": 0}
    np.testing.assert_array_equal(got, expected[name])

    out = []
    sr = tcodec.FpvtStreamingReader(lambda f, _ts: out.append(f),
                                    device="cpu")
    before = dict(tfpvt.PARSED_STREAMS)
    rng = np.random.default_rng(len(data))
    pos = 0
    while pos < len(data):
        step = int(rng.integers(1, 4000))
        sr.decode(data[pos : pos + step])
        pos += step
    assert _delta(before) == {"view": n, "copy": 0}
    np.testing.assert_array_equal(np.concatenate(out), expected[name])

    offsets = [off for off, _n in tfpvt.parse_footer(data)]
    n_batch = _counted([st for off in offsets
                        for pb in [tfpvt.parse_batch_section(data, off)]
                        for st in (pb.high, pb.low, pb.preview)
                        if st is not None])
    reader = tcodec.FpvtReader(data, device="cpu")
    mutable = bytearray(data)
    before = dict(tfpvt.PARSED_STREAMS)
    got = np.concatenate([reader._issue((mutable, off))()[0]
                          for off in offsets])
    assert _delta(before) == {"view": 0, "copy": n_batch}
    np.testing.assert_array_equal(got, expected[name][-len(got):])


def _payload_offset(data: bytes, st) -> int:
    """The file offset of a parsed (view) stream's payload."""
    base = np.frombuffer(data, np.uint8).__array_interface__["data"][0]
    return st.payload.__array_interface__["data"][0] - base


def test_fused_decode_ok_flags_equal_from_views_and_copies():
    """``batch_decode_args`` of a batch parsed from ``bytes`` and from a
    bytearray are equal, and ``fused_decode_batch`` gives the same frames
    and ``ok`` from both: true on the file, false on a copy whose low
    plane's payload has a flipped word."""
    data = FILES["mixed-wide"]
    r = tcodec.FpvtReader(data, device="cpu")
    h, w, k = r.header.ysize, r.header.xsize, 1 << r.header.chunk_log2
    off, b = r._batches[0]
    bad = bytearray(data)
    pb = tfpvt.parse_batch_section(data, off, h * w, (h // 4) * (w // 4))
    assert pb.low.coding == CODING_CTX16
    bad[_payload_offset(data, pb.low) + 6] ^= 0x5A
    for buf, want_ok in ((data, True), (bytes(bad), False)):
        results = []
        for src in (buf, bytearray(buf)):
            pbs = tfpvt.parse_batch_section(src, off, h * w,
                                            (h // 4) * (w // 4))
            arrays, static = tcodec.batch_decode_args(pbs, k)
            imgs, ok = tcodec.fused_decode_batch(
                **arrays, delta_high=r._delta_high, delta_low=r._delta_low,
                chunk_len=k, b=b, h=h, w=w, **static, device="cpu")
            results.append((arrays, imgs, bool(ok)))
        (a0, i0, ok0), (a1, i1, ok1) = results
        assert ok0 == ok1 == want_ok
        for key in a0:
            np.testing.assert_array_equal(a0[key], a1[key])
        assert torch.equal(i0, i1)


def test_streaming_reader_compacts_past_4_mib_in_uneven_pieces():
    """A stream of more than 4 MiB (a 16-bit file whose RAW noise batch
    section is repeated after its coded plasma one, under a footer of its
    own) fed in uneven pieces: the streaming reader drops consumed bytes
    as it goes, raises no BufferError, counts every stream as a view of
    its buffer and decodes pixel-exact, as JAX's reader and the port's
    ``bytes`` reader decode the same file."""
    frames = np.concatenate([
        testdata.plasma_frames(2, 256, 256, bits=16, seed=6),
        testdata.noise_frames(2, 256, 256)])
    base = _wide(frames, [1, 2], shift=0)
    (coded, n0), (noise, n1) = tfpvt.parse_footer(base)
    end = len(base) - tfpvt.footer_size(2)
    reps = -(-(5 << 20) // (end - noise))
    offsets = [(coded, n0)] + [(noise + i * (end - noise), n1)
                               for i in range(reps)]
    data = (base[:end] + base[noise:end] * (reps - 1)
            + tfpvt.serialize_footer(offsets, 1 + n0 + reps * n1))
    assert len(data) > 5 << 20
    want = jcodec.decode_file_fpvt(data)
    np.testing.assert_array_equal(
        fpv_tpu_torch.decode_file_fpvt(data, device="cpu"), want)
    n = _counted(_parse_file(bytearray(data))[0])
    out = []
    sr = tcodec.FpvtStreamingReader(lambda f, _ts: out.append(f),
                                    device="cpu")
    before = dict(tfpvt.PARSED_STREAMS)
    rng = np.random.default_rng(9)
    pos = 0
    while pos < len(data):
        step = int(rng.integers(1, 400_000))
        sr.decode(data[pos : pos + step])
        pos += step
    assert sr._abs_base > 4 << 20  # compacted
    assert _delta(before) == {"view": n, "copy": 0}
    np.testing.assert_array_equal(np.concatenate(out), want)


# crafted plane streams: one field of a real stream changed, parsed from
# bytes and from a bytearray; each must fail the check it failed before


def _streams():
    """A serialized order-0, ctx16, RAW and CONST stream, each with its
    frame count and plane size."""
    data = FILES["mixed-narrow"]
    hdr = tfpvt.Header.parse(data)
    out = {}
    for off, n in tfpvt.parse_footer(data):
        pb = tfpvt.parse_batch_section(data, off)
        for st in (pb.high, pb.low, pb.preview):
            out.setdefault(st.coding, (tfpvt.serialize_plane_stream(st), n,
                                       st.plane_size))
    const = FILES["const"]
    pb = tfpvt.parse_batch_section(const, tfpvt.parse_footer(const)[0][0])
    out[CODING_CONST] = (tfpvt.serialize_plane_stream(pb.high),
                         len(pb.frame_flags), pb.high.plane_size)
    assert hdr.ysize * hdr.xsize == out[CODING_ORDER0][2]
    return out


STREAMS = _streams()


def _put(fmt, pos, value):
    return lambda b: struct.pack_into(fmt, b, pos, value)


def _xor(pos, bit=1):
    def f(b):
        b[pos] ^= bit
    return f


def _counts_at(coding):
    """Offset of a coded stream's first block count."""
    blob = STREAMS[coding][0]
    (num_chunks,) = struct.unpack_from("<I", blob, 12)
    return 24 + 512 + 4 * num_chunks


_RAW_N = len(STREAMS[CODING_RAW][0]) - 24  # stored bytes, pad included

# name -> (coding, mutation, cut to this many bytes or None, error match)
CRAFTED = {
    "intact-order0": (CODING_ORDER0, None, None, None),
    "intact-raw": (CODING_RAW, None, None, None),
    "chunk-length": (CODING_ORDER0, _put("<I", 8, 24), None,
                     "chunk length"),
    "plane-size": (CODING_ORDER0, _put("<I", 4, 1 << 20), None,
                   "does not match frame geometry"),
    "const-value": (CODING_CONST, _put("<H", 22, 300), None,
                    "constant plane value"),
    "unknown-coding": (CODING_ORDER0, _put("<I", 16, 9), None,
                       "unknown plane-stream coding"),
    "lane-count": (CODING_ORDER0, _put("<H", 20, 12), None, "lane count"),
    "chunk-count": (CODING_ORDER0, _put("<I", 12, 1), None,
                    "chunk count mismatch"),
    "order0-table": (CODING_ORDER0, _xor(24), None, "frequency table"),
    "ctx16-table": (CODING_CTX16, _xor(24), None, "frequency table"),
    "block-count": (CODING_ORDER0, _put("<I", _counts_at(CODING_ORDER0),
                                        1 << 30), None, "block count"),
    "coded-overrun": (CODING_ORDER0, _put("<I", 0, 24 + 512), None,
                      "overruns section"),
    "coded-truncated": (CODING_CTX16, None, 24 + 512 + 40, "truncated"),
    "raw-checksum": (CODING_RAW, _xor(30, 0x10), None, "checksum mismatch"),
    "raw-overrun": (CODING_RAW, _put("<I", 0, 24 + _RAW_N // 2), None,
                    "overruns section"),
    "raw-truncated": (CODING_RAW, None, 24 + _RAW_N // 2, "truncated"),
    "header-truncated": (CODING_ORDER0, None, 20, "truncated"),
}


@pytest.mark.parametrize("kind", ["bytes", "bytearray"])
@pytest.mark.parametrize("case", list(CRAFTED))
def test_crafted_stream_fails_its_check(case, kind):
    coding, mutate, cut, match = CRAFTED[case]
    blob, n, size = STREAMS[coding]
    b = bytearray(blob)
    if mutate is not None:
        mutate(b)
    if cut is not None:
        b = b[:cut]
    buf = bytes(b) if kind == "bytes" else b
    before = dict(tfpvt.PARSED_STREAMS)
    if match is None:
        st, end = tfpvt.parse_plane_stream(buf, 0, n, expect_size=size)
        assert end == len(blob) and st.coding == coding
        assert sum(_delta(before).values()) == 1
        return
    with pytest.raises(ValueError, match=match):
        tfpvt.parse_plane_stream(buf, 0, n, expect_size=size)
    assert _delta(before) == {"view": 0, "copy": 0}


@pytest.mark.parametrize("kind", ["bytes", "bytearray"])
@pytest.mark.parametrize("case", ["frame-count", "truncated", "type"])
def test_crafted_batch_section_fails_its_check(case, kind):
    data = FILES["mixed-narrow"]
    off, _n = tfpvt.parse_footer(data)[0]
    (size,) = struct.unpack_from("<Q", data, off)
    b = bytearray(data[off : off + size])
    if case == "frame-count":
        struct.pack_into("<I", b, 9, 0)
        match = "invalid batch frame count"
    elif case == "truncated":
        b = b[: size - 100]
        match = "truncated"
    else:
        b[8] = tfpvt.SECTION_DELTA
        match = "expected batch section"
    buf = bytes(b) if kind == "bytes" else b
    with pytest.raises(ValueError, match=match):
        tfpvt.parse_batch_section(buf, 0)

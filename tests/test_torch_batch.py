"""The port's columnar batch subsystem and Arrow frontend against the JAX
package's, on the CPU.

Mirrors tests/test_batch.py.  The same frames go through both encoders:
the batches' timestamps, flags, offset tables, payload regions and the
schema's compressed delta planes (columnar), the RecordBatch columns and
schema metadata (Arrow) must be equal, and the decoded images equal for
every ``ImageType``.  Also here: the three brotli additions
(``decompress_stream``, ``max_compressed_size``, ``compress_into``)
against the JAX package's.
"""

import numpy as np
import pytest
import torch

from fpv_tpu.batch import columnar as jcol
from fpv_tpu.entropy import brotli as jbrotli
from fpv_tpu.utils import testdata
from fpv_tpu_torch.batch import columnar as tcol
from fpv_tpu_torch.entropy import brotli as tbrotli

CPU = dict(device="cpu")


def _encode(mod, frames, shift=0, frames_per_batch=4, **kw):
    batches = []

    def processor(batch):
        if batch is not None:
            batches.append(batch)

    enc = mod.ColumnarBatchEncoder(
        frames.shape[2], frames.shape[1], shift, False, processor,
        frames_per_batch=frames_per_batch, **kw,
    )
    futures = [
        enc.push_frame(100 + i, frames[i], info=i) for i in range(len(frames))
    ]
    assert [f.result(timeout=60) for f in futures] == list(range(len(frames)))
    last_ts = enc.close().result(timeout=60)
    enc.join()
    assert last_ts == 100 + len(frames) - 1
    return batches


def _both(frames, shift=0, frames_per_batch=4):
    """Port and JAX batches of ``frames``, held equal array by array."""
    ours = _encode(tcol, frames, shift, frames_per_batch, **CPU)
    theirs = _encode(jcol, frames, shift, frames_per_batch)
    assert [b.length for b in ours] == [b.length for b in theirs]
    for a, b in zip(ours, theirs):
        n = a.length
        for name in ("_timestamps", "_flags"):
            np.testing.assert_array_equal(getattr(a, name)[:n],
                                          getattr(b, name)[:n])
        for region in ("preview", "high", "low"):
            off_a = getattr(a, f"_{region}_offsets")[: n + 1]
            np.testing.assert_array_equal(
                off_a, getattr(b, f"_{region}_offsets")[: n + 1])
            np.testing.assert_array_equal(
                getattr(a, f"_{region}")[: off_a[-1]],
                getattr(b, f"_{region}")[: off_a[-1]])
        sa, sb = a.schema, b.schema
        assert sa.compressed_delta_high == sb.compressed_delta_high
        assert sa.compressed_delta_low == sb.compressed_delta_low
        assert (sa.xsize, sa.ysize, sa.shifted_left) == (
            sb.xsize, sb.ysize, sb.shifted_left)
    return ours, theirs


def _decode(mod, batches, type, unshift=False, **kw):
    images = []
    dec = mod.ColumnarBatchDecoder(type, unshift=unshift,
                                   image_processor=images.append, **kw)
    for b in batches:
        assert dec.push_batch(b).result(timeout=60) is b
    dec.close().result(timeout=60)
    dec.join()
    return images


def _decode_both(ours, theirs, type, unshift=False):
    """Port and JAX images of every frame: equal records."""
    got = _decode(tcol, ours, getattr(tcol.ImageType, type.name), unshift,
                  **CPU)
    want = _decode(jcol, theirs, type, unshift)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.timestamp, g.xsize, g.ysize, g.bpp, g.type.name) == (
            w.timestamp, w.xsize, w.ysize, w.bpp, w.type.name)
        np.testing.assert_array_equal(g.data, w.data)
    return got


def test_columnar_roundtrip_full():
    frames = testdata.ramp_frames(7, 24, 32)
    ours, theirs = _both(frames, frames_per_batch=3)
    assert [b.length for b in ours] == [3, 3, 1]
    images = _decode_both(ours, theirs, jcol.ImageType.FULL)
    assert len(images) == 7
    for i, img in enumerate(images):
        assert img.timestamp == 100 + i
        np.testing.assert_array_equal(img.data16().reshape(24, 32), frames[i])


def test_columnar_unshift_and_msb8():
    frames = testdata.plasma_frames(4, 16, 16, bits=12)
    ours, theirs = _both(frames, shift=4, frames_per_batch=4)
    images = _decode_both(ours, theirs, jcol.ImageType.FULL, unshift=True)
    for i, img in enumerate(images):
        assert img.bpp == 12
        np.testing.assert_array_equal(img.data16().reshape(16, 16), frames[i])
    msb = _decode_both(ours, theirs, jcol.ImageType.MSB8)
    for i, img in enumerate(msb):
        expect = ((frames[i].astype(np.uint16) << 4) >> 8).astype(np.uint8)
        np.testing.assert_array_equal(img.data8().reshape(16, 16), expect)


def test_columnar_previews():
    frames = testdata.plasma_frames(2, 32, 32)
    ours, theirs = _both(frames, frames_per_batch=2)
    images = _decode_both(ours, theirs, jcol.ImageType.PREVIEW)
    for i, img in enumerate(images):
        assert (img.xsize, img.ysize, img.bpp) == (8, 8, 8)
        high = (frames[i] >> 8).astype(np.uint32)
        expect = ((high.reshape(8, 4, 8, 4).sum(axis=(1, 3)) // 16) & 0xFE)
        np.testing.assert_array_equal(
            img.data8().reshape(8, 8), expect.astype(np.uint8)
        )


def test_batch_recycling():
    frames = testdata.ramp_frames(6, 16, 16)
    batches = []
    enc = tcol.ColumnarBatchEncoder(16, 16, 0, False,
                                    lambda b: batches.append(b) if b else None,
                                    frames_per_batch=3, **CPU)
    for i in range(3):
        enc.push_frame(i, frames[i]).result(timeout=60)
    import time

    for _ in range(100):
        if batches:
            break
        time.sleep(0.05)
    assert batches
    first = batches[0]
    enc.return_processed_batch(first)  # recycle
    for i in range(3, 6):
        enc.push_frame(i, frames[i]).result(timeout=60)
    enc.close().result(timeout=60)
    enc.join()
    assert len(batches) == 2
    assert batches[1] is first  # recycled arena reused


def test_random_frames_stress():
    """Random frames like columnar_batch_encoder_test.cc:41-50."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 1 << 16, size=(50, 16, 16), dtype=np.uint16)
    ours, theirs = _both(frames, frames_per_batch=13)
    images = _decode_both(ours, theirs, jcol.ImageType.FULL)
    for i, img in enumerate(images):
        np.testing.assert_array_equal(img.data16().reshape(16, 16), frames[i])


@pytest.mark.parametrize("case", ["no-low-delta", "shift8", "uint8"])
def test_columnar_low_plane_cases_equal_jax(case):
    """A frame without low bytes after a delta frame with them (zeros, not
    the delta frame's low plane), a shift-8 stream (no low planes, an
    empty compressed delta low plane) and 8-bit input: every type."""
    rng = np.random.default_rng(3)
    if case == "no-low-delta":
        frames = np.stack([rng.integers(0, 1 << 16, (16, 16)),
                           rng.integers(0, 256, (16, 16)) << 8,
                           rng.integers(0, 1 << 16, (16, 16))]
                          ).astype(np.uint16)
        shift, want = 0, frames
    else:
        frames = testdata.plasma_frames(3, 16, 16, bits=8, seed=4)
        if case == "uint8":
            frames = frames.astype(np.uint8)
        shift, want = 8, frames.astype(np.uint16) << 8
    ours, theirs = _both(frames, shift=shift, frames_per_batch=2)
    if case != "no-low-delta":
        assert ours[0].schema.compressed_delta_low == b""
    images = _decode_both(ours, theirs, jcol.ImageType.FULL)
    for img, w in zip(images, want):
        np.testing.assert_array_equal(img.data16().reshape(16, 16), w)
    for type in (jcol.ImageType.MSB8, jcol.ImageType.PREVIEW):
        _decode_both(ours, theirs, type)


def test_extract_image_single_frames_equal_batch():
    frames = testdata.plasma_frames(5, 24, 24, bits=12, seed=2)
    ours, _theirs = _both(frames, shift=4, frames_per_batch=5)
    b = ours[0]
    for type in tcol.ImageType:
        whole = b.extract_images(type)
        for i in range(b.length):
            np.testing.assert_array_equal(b.extract_image(i, type).data,
                                          whole[i].data)
    with pytest.raises(IndexError):
        b.extract_image(b.length, tcol.ImageType.FULL)


def test_columnar_decoder_rejects_foreign_schema():
    frames = testdata.ramp_frames(2, 16, 16)
    a = _encode(tcol, frames, **CPU)
    b = _encode(tcol, frames, **CPU)
    dec = tcol.ColumnarBatchDecoder(tcol.ImageType.FULL, False, lambda i: None,
                                    **CPU)
    dec.push_batch(a[0]).result(timeout=60)
    with pytest.raises(ValueError, match="foreign"):
        dec.push_batch(b[0]).result(timeout=60)
    dec.join()


def _arrow_both(frames, shift, fpb):
    """Port and JAX RecordBatches of ``frames``: equal schemas (metadata
    included) and columns."""
    pa = pytest.importorskip("pyarrow")
    from fpv_tpu.batch import arrow as jarrow
    from fpv_tpu_torch.batch import arrow as tarrow

    out = []
    h, w = frames.shape[1:]
    for mod, kw in ((tarrow, CPU), (jarrow, {})):
        rbs = []
        enc = mod.ArrowEncoder(w, h, shift, False,
                               lambda rb: rbs.append(rb) if rb else None,
                               frames_per_batch=fpb, **kw)
        for i in range(len(frames)):
            enc.push_frame(1000 + i, frames[i]).result(timeout=60)
        enc.close().result(timeout=60)
        enc.join()
        out.append(rbs)
    ours, theirs = out
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.schema.equals(b.schema, check_metadata=True)
        assert a.equals(b)
    assert isinstance(ours[0], pa.RecordBatch)
    return ours, jarrow.decode_record_batch, tarrow.decode_record_batch


def test_arrow_encoder_roundtrip():
    frames = testdata.plasma_frames(5, 24, 24, bits=12)
    ours, jdec, tdec = _arrow_both(frames, 4, 2)
    assert [rb.num_rows for rb in ours] == [2, 2, 1]
    rb = ours[0]
    assert rb.schema.names == [
        "timestamp", "deltaPredicted", "cgPredicted", "preview",
        "highBytePlane", "lowBytePlane",
    ]
    md = rb.schema.metadata
    assert md[b"xsize"] == b"24" and md[b"shiftedLeft"] == b"4"
    decoded = []
    for rb in ours:
        got = tdec(rb, **CPU)
        for g, w in zip(got, jdec(rb)):
            np.testing.assert_array_equal(g, w)
        decoded.extend(got)
    for i, img in enumerate(decoded):
        np.testing.assert_array_equal(img, (frames[i].astype(np.uint16) << 4))


def test_arrow_no_low_plus_delta_roundtrip():
    """A frame whose ORIGINAL low plane is all zero (NO_LOW_BYTES) while the
    delta frame has nonzero low bytes decodes with a ZERO low plane, not
    the delta frame's."""
    rng = np.random.default_rng(3)
    delta = rng.integers(0, 1 << 16, (16, 16)).astype(np.uint16)  # low != 0
    frame = (rng.integers(0, 256, (16, 16)).astype(np.uint16)) << 8  # low == 0
    ours, jdec, tdec = _arrow_both(np.stack([delta, frame]), 0, 4)
    decoded = [img for rb in ours for img in tdec(rb, **CPU)]
    assert all((g == w).all() for rb in ours
               for g, w in zip(tdec(rb, **CPU), jdec(rb)))
    np.testing.assert_array_equal(decoded[0], delta)
    np.testing.assert_array_equal(decoded[1], frame)


def test_arrow_shift8_has_no_delta_low_plane():
    frames = testdata.plasma_frames(3, 16, 16, bits=8, seed=4)
    ours, jdec, tdec = _arrow_both(frames, 8, 2)
    assert ours[0].schema.metadata[b"deltaFrameLowPlane"] == b""
    for rb in ours:
        for g, w in zip(tdec(rb, **CPU), jdec(rb)):
            np.testing.assert_array_equal(g, w)


def test_arrow_empty_close_does_not_deadlock():
    pytest.importorskip("pyarrow")
    from fpv_tpu_torch.batch.arrow import ArrowEncoder

    enc = ArrowEncoder(16, 16, 0, False, lambda rb: None, **CPU)
    assert enc.close().result(timeout=60) == -1
    enc.join()


def test_arrow_worker_error_surfaces():
    """A predict/compress failure surfaces through close(), not killing the
    serializer thread silently."""
    pytest.importorskip("pyarrow")
    from concurrent.futures import Future

    from fpv_tpu_torch.batch.arrow import ArrowEncoder

    enc = ArrowEncoder(16, 16, 0, False, lambda rb: None, **CPU)
    enc.push_frame(0, np.zeros((16, 16), np.uint16)).result(timeout=60)
    boom: Future = Future()
    boom.set_exception(ValueError("boom"))
    enc._queue.put(boom)  # a frame whose pipeline stage failed
    with pytest.raises(ValueError):
        enc.close().result(timeout=60)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    calls = [lambda: tcol.ColumnarBatchEncoder(8, 8, 0, False, print),
             lambda: tcol.ColumnarBatchDecoder(tcol.ImageType.FULL, False,
                                               print)]
    try:
        from fpv_tpu_torch.batch import arrow as tarrow
    except ImportError:
        tarrow = None
    if tarrow is not None:
        calls.append(lambda: tarrow.ArrowEncoder(8, 8, 0, False, print))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_brotli_additions_equal_jax():
    rng = np.random.default_rng(5)
    planes = [rng.integers(0, 256, n, dtype=np.uint8).astype(np.uint8)
              for n in (0, 1, 1000)] + [np.zeros(70_000, np.uint8),
                                        np.arange(100_000) % 251]
    planes = [np.ascontiguousarray(p, dtype=np.uint8) for p in planes]
    for n in (0, 1, 100, 1 << 20, 1 << 30):
        assert tbrotli.max_compressed_size(n) == jbrotli.max_compressed_size(n)
    for p in planes:
        want = jbrotli.compress(p.tobytes())
        dest = bytearray(tbrotli.max_compressed_size(p.size) + 7)
        n = tbrotli.compress_into(p, memoryview(dest))
        assert bytes(dest[:n]) == want == tbrotli.compress(p)
        jdest = bytearray(len(dest))
        assert jbrotli.compress_into(p, memoryview(jdest)) == n
        # two concatenated streams: the first one's end position
        blob = b"xy" + want + jbrotli.compress(b"second")
        got = tbrotli.decompress_stream(blob, 2)
        assert got == jbrotli.decompress_stream(blob, 2)
        assert got[0] == p.tobytes()
        assert tbrotli.decompress_stream(blob, got[1]) == (b"second",
                                                           len(blob))
    with pytest.raises(ValueError, match="larger"):
        tbrotli.decompress_stream(jbrotli.compress(bytes(5000)), max_size=4999)
    assert tbrotli.decompress_stream(jbrotli.compress(bytes(5000)),
                                     max_size=5000)[0] == bytes(5000)
    for bad in (b"", b"\x01\x02\x03", jbrotli.compress(bytes(9000))[:-2]):
        with pytest.raises(ValueError):
            tbrotli.decompress_stream(bad)
        with pytest.raises(ValueError):
            jbrotli.decompress_stream(bad)
    with pytest.raises(ValueError, match="smaller"):
        tbrotli.compress_into(planes[2], memoryview(bytearray(10)))
    with pytest.raises(ValueError, match="writable"):
        tbrotli.compress_into(planes[2], bytes(2000))

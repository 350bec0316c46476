"""fpv_tpu_torch.utils.profiling: traces and annotations, and the codec's
``fpvt.*`` spans as the benchmark's trace reduction
(``fpvbench.trace.from_profiler``) sees them."""

import collections
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import fpv_tpu_torch
from fpv_tpu_torch.api import fpvt_codec
from fpv_tpu_torch.entropy import plane_codec
from fpv_tpu_torch.format.fpvt import F_USE_PREV
from fpv_tpu_torch.utils import profiling, testdata
from fpvbench import trace as tracing


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("fpvt.test_span"):
            torch.arange(4096).sum()
    assert prof is not None
    (path,) = tmp_path.glob("fpvt_trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert "fpvt.test_span" in names


def test_trace_records_ranges_of_pool_threads(tmp_path):
    """The sharded paths annotate their phases on pool threads."""
    def work(i):
        with profiling.annotate(f"fpvt.worker{i}"):
            torch.arange(1024).sum()

    with profiling.trace(str(tmp_path)) as prof:
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(work, range(2)))
    keys = {e.key for e in prof.key_averages()}
    assert {"fpvt.worker0", "fpvt.worker1"} <= keys


def test_trace_without_a_directory_is_a_no_op(monkeypatch, tmp_path):
    monkeypatch.delenv("FPV_TPU_TRACE_DIR", raising=False)
    with profiling.trace() as prof:
        pass
    assert prof is None
    monkeypatch.setenv("FPV_TPU_TRACE_DIR", str(tmp_path / "env"))
    with profiling.trace():
        pass
    assert len(list((tmp_path / "env").glob("fpvt_trace_*.json"))) == 1


def test_annotate_lets_exceptions_through():
    with pytest.raises(ValueError, match="inside"):
        with profiling.annotate("fpvt.failing"):
            raise ValueError("raised inside the range")


def test_annotate_opens_a_range_only_while_a_profiler_records(monkeypatch):
    opened = []
    real = torch._C._profiler._RecordFunctionFast

    def spy(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", spy)
    with profiling.annotate("fpvt.off"):
        torch.arange(8).sum()
    with pytest.raises(ValueError, match="off"):
        with profiling.annotate("fpvt.off_raising"):
            raise ValueError("raised with the profiler off")
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("fpvt.on"):
            torch.arange(8).sum()
        with pytest.raises(ValueError, match="on"):
            with profiling.annotate("fpvt.on_raising"):
                raise ValueError("raised with the profiler on")
    assert opened == ["fpvt.on", "fpvt.on_raising"]
    keys = {e.key for e in prof.key_averages()}
    assert {"fpvt.on", "fpvt.on_raising"} <= keys
    assert "fpvt.off" not in keys


# the codec's spans, on the CPU at a small size

FRAMES = testdata.plasma_frames(9, 32, 64, bits=12)
FPB = 3  # frame 0 is the delta section: batches of 3, 3 and 2


@pytest.fixture
def wide(monkeypatch):
    """Files in the fused 1024-lane geometry, where decode_frame decodes
    only the covering blocks and walks prev chains."""
    monkeypatch.setattr(plane_codec, "NARROW_MAX_SYMS", 0)


def _encode(**kw):
    return fpv_tpu_torch.encode_file_fpvt(
        FRAMES, shift=4, frames_per_batch=kw.pop("fpb", FPB), chunk_log2=6,
        device="cpu", **kw)


def _traced(fn):
    """``fn()`` inside a ``window`` range under the profiler -> (its
    result, the reduced trace, the program spans on the window's thread
    in start order)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tracing.WINDOW):
            out = fn()
    tr = tracing.from_profiler(prof)
    (win,) = [h for h in tr.host if h.name == tracing.WINDOW]
    spans = sorted((h for h in tr.host if h.name.startswith("fpvt.")
                    and h.thread == win.thread), key=lambda h: h.start)
    return out, tr, spans


def _names(spans):
    return collections.Counter(h.name for h in spans)


def test_decode_file_spans_every_stage_inside_the_window(wide):
    data = _encode()
    out, tr, spans = _traced(
        lambda: fpv_tpu_torch.decode_file_fpvt(data, device="cpu"))
    assert (out == FRAMES << 4).all()
    batches = 3
    assert _names(spans) == {
        "fpvt.read.open": 1, "fpvt.read.assemble": 1,
        **{f"fpvt.read.{s}": batches
           for s in ("parse", "stage", "dispatch", "finalize")}}
    w0, w1 = tr.window
    assert all(w0 <= h.start <= h.end <= w1 for h in spans)
    # open first, assemble last; each batch parsed, staged, dispatched in
    # turn, and finalized after it was dispatched
    assert spans[0].name == "fpvt.read.open"
    assert spans[-1].name == "fpvt.read.assemble"
    steps = [h for h in spans if h.name in (
        "fpvt.read.parse", "fpvt.read.stage", "fpvt.read.dispatch")]
    assert [h.name.rsplit(".", 1)[1] for h in steps] == [
        "parse", "stage", "dispatch"] * batches
    dispatched = [h.end for h in spans if h.name == "fpvt.read.dispatch"]
    finalized = [h.start for h in spans if h.name == "fpvt.read.finalize"]
    assert all(d <= f for d, f in zip(dispatched, finalized))
    # the spans follow one another: none encloses another
    assert all(a.end <= b.start for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("delta", ["frame0", "explicit"])
def test_decode_file_downloads_frame0_inside_assemble(wide, monkeypatch,
                                                      delta):
    """Frame 0's download into the output opens no span of its own, and
    the output's branch (here over the pinned cap) adds none: a file
    still ends in one ``fpvt.read.assemble``, one set of spans a batch."""
    monkeypatch.setattr(fpvt_codec, "PINNED_OUTPUT_MAX_BYTES", 1)
    if delta == "frame0":
        data, want, batches = _encode(), FRAMES << 4, 3
    else:  # batches of frames 1-3 and 4-6, no synthesized frame 0
        data = fpv_tpu_torch.encode_file_fpvt(
            FRAMES[1:7], shift=4, frames_per_batch=FPB, chunk_log2=6,
            delta_frame=FRAMES[0], device="cpu")
        want, batches = FRAMES[1:7] << 4, 2
    out, _tr, spans = _traced(
        lambda: fpv_tpu_torch.decode_file_fpvt(data, device="cpu"))
    np.testing.assert_array_equal(out, want)
    assert _names(spans) == {
        "fpvt.read.open": 1, "fpvt.read.assemble": 1,
        **{f"fpvt.read.{s}": batches
           for s in ("parse", "stage", "dispatch", "finalize")}}
    assert spans[-1].name == "fpvt.read.assemble"
    assert all(a.end <= b.start for a, b in zip(spans, spans[1:]))


def test_decode_frame_spans_each_chain_frame(wide):
    """A request that walks a prev chain of several frames opens one
    ``fpvt.read.chain`` span, around the whole chain's staging and its one
    decode, between the parse and the download."""
    data = _encode(fpb=4)  # batches of frames 1-4 and 5-8
    probe = fpv_tpu_torch.FpvtReader(data, device="cpu")
    off, _b = probe._batches[1]
    flags = probe._parse_batch(off).frame_flags
    j = 3  # frame 8
    j0 = j
    while j0 > 0 and flags[j0] & F_USE_PREV:
        j0 -= 1
    assert j - j0 >= 1  # a chain to walk
    reader = fpv_tpu_torch.FpvtReader(data, device="cpu")
    got, _tr, spans = _traced(lambda: reader.decode_frame(8))
    assert (got == FRAMES[8] << 4).all()
    assert _names(spans) == {"fpvt.read.chain": 1,
                             "fpvt.read.parse": 1, "fpvt.read.download": 1}
    assert spans[0].name == "fpvt.read.parse"
    assert spans[-1].name == "fpvt.read.download"
    # frame 0 is the delta frame: nothing to parse, no chain
    got, _tr, spans = _traced(lambda: reader.decode_frame(0))
    assert (got == FRAMES[0] << 4).all()
    assert _names(spans) == {"fpvt.read.download": 1}


def test_writer_spans_one_set_per_batch(wide):
    data, _tr, spans = _traced(_encode)
    assert data == _encode()
    batches = 3
    assert _names(spans) == {"fpvt.write.upload": batches,
                             "fpvt.write.code": batches,
                             "fpvt.write.serialize": batches,
                             "fpvt.write.join": 1}
    assert [h.name.rsplit(".", 1)[1] for h in spans] == [
        "upload", "code", "serialize"] * batches + ["join"]


def test_plane_ingest_spans_its_upload():
    wri = fpv_tpu_torch.FpvtWriter(64, 32, shift=0, frames_per_batch=2,
                                   chunk_log2=6, device="cpu")
    wri.init_planes((FRAMES[0] >> 8).astype(np.uint8),
                    (FRAMES[0] & 0xFF).astype(np.uint8))
    body = FRAMES[1:3]
    _sec, _tr, spans = _traced(lambda: wri.encode_batch_planes(
        (body >> 8).astype(np.uint8), (body & 0xFF).astype(np.uint8)))
    assert [h.name for h in spans] == [
        "fpvt.write.upload", "fpvt.write.code", "fpvt.write.serialize"]


def test_spans_change_no_bytes_and_no_frames(wide):
    plain = _encode()
    traced, _tr, _spans = _traced(_encode)
    assert traced == plain
    want = fpv_tpu_torch.decode_file_fpvt(plain, device="cpu")
    got, _tr, _spans = _traced(
        lambda: fpv_tpu_torch.decode_file_fpvt(plain, device="cpu"))
    assert got.dtype == want.dtype and (got == want).all()
    reader = fpv_tpu_torch.FpvtReader(plain, device="cpu")
    frames, _tr, _spans = _traced(
        lambda: [reader.decode_frame(i) for i in (8, 4, 0, 7)])
    again = fpv_tpu_torch.FpvtReader(plain, device="cpu")
    assert all((f == again.decode_frame(i)).all()
               for f, i in zip(frames, (8, 4, 0, 7)))


def test_no_program_span_among_the_device_intervals(wide):
    """The spans are host operations, not user annotations, so kineto makes
    no copy of them on the card's timeline (there, a copy of a range that
    launched kernels would read as device work): the trace reduction finds
    them among the host spans and never among the device intervals."""
    data = _encode()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tracing.WINDOW):
            fpv_tpu_torch.decode_file_fpvt(data, device="cpu")
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("fpvt.")]
    assert len(events) == 14  # open, 3 x 4 batch stages, assemble
    assert not [e.name() for e in events if e.is_user_annotation()]
    tr = tracing.from_profiler(prof)
    assert not [d.name for d in tr.device if d.name.startswith("fpvt.")]
    assert {h.name for h in tr.host} >= {e.name() for e in events}

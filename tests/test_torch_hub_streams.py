"""The decode hub as a long-lived server of camera streams: fpv_tpu_torch's
``MultiStreamDecoder`` against the plain demultiplexer
``fpvbench/reference/multistream.py`` (each stream's chunks joined and
decoded whole by the plain FPVT reader), under any chunking and any
interleaving; ``end_stream`` retiring one stream while the others go on;
the hub's spans and counters.  Everything runs on the CPU, where the
kernel wrappers run their plain versions."""

import gc
import sys
import threading
import weakref

import numpy as np
import pytest

import fpv_tpu_torch
from fpv_tpu_torch.api import multistream
from fpv_tpu_torch.format import fpvt as tfpvt
from fpv_tpu_torch.utils import testdata
from fpvbench.reference import multistream as ref

H, W, N = 16, 32, 7
GEOM = dict(shift=4, frames_per_batch=3, chunk_log2=6, device="cpu")


def _recording(seed):
    return testdata.plasma_frames(N, H, W, bits=12, seed=seed)


@pytest.fixture(scope="module")
def shot():
    """Four 12-bit streams (frame 0 the delta section, batches of 3) ->
    (recordings, files, the plain demultiplexer's answer on whole files)."""
    recs = {f"cam{i}": _recording(40 + i) for i in range(4)}
    files = {sid: fpv_tpu_torch.encode_file_fpvt(r, **GEOM)
             for sid, r in recs.items()}
    return recs, files, ref.decode(files.items())


def _chunks(data, sizes):
    """``data`` cut into pieces of the sizes in ``sizes``, cycled."""
    out, pos, i = [], 0, 0
    while pos < len(data):
        n = sizes[i % len(sizes)]
        out.append(memoryview(data)[pos : pos + n])
        pos, i = pos + n, i + 1
    return out


def _schedule(files, sizes, order, seed=5):
    """Every stream's chunks, interleaved round-robin or at random."""
    queues = {sid: _chunks(data, sizes) for sid, data in files.items()}
    rng = np.random.default_rng(seed)
    out = []
    while any(queues.values()):
        live = [sid for sid, q in queues.items() if q]
        picks = live if order == "round_robin" else [
            live[int(rng.integers(len(live)))]]
        for sid in picks:
            out.append((sid, queues[sid].pop(0)))
    return out


class Sink:
    """The frames and timestamps a hub delivers, per stream."""

    def __init__(self):
        self.got, self.calls = {}, 0

    def __call__(self, sid, frames, ts):
        self.calls += 1
        fr, stamps = self.got.setdefault(sid, ([], []))
        fr.append(frames.copy())
        stamps.append(ts)

    def stream(self, sid):
        fr, stamps = self.got[sid]
        return np.concatenate(fr), np.concatenate(stamps)


def _assert_equal_to_reference(sink, want, recs):
    assert set(sink.got) == set(want)
    for sid, (frames, stamps) in want.items():
        got_fr, got_ts = sink.stream(sid)
        np.testing.assert_array_equal(got_fr.astype(np.int32),
                                      frames.numpy())
        np.testing.assert_array_equal(got_ts, stamps)
        np.testing.assert_array_equal(got_fr, recs[sid] << 4)


CHUNKINGS = {
    "byte": [1],
    # 7 splits the 32-byte header, 13 and 33 every section at a new place
    "split": [7, 13, 33],
    "mib": [1 << 20],
    "whole": [1 << 40],
}


@pytest.mark.parametrize("order", ["round_robin", "random"])
@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
def test_hub_equals_plain_demultiplexer(shot, chunking, order):
    """Any chunking and interleaving: each stream gets its frames once,
    in order, equal to the plain reference's and to the recording's."""
    recs, files, want = shot
    sink = Sink()
    hub = fpv_tpu_torch.MultiStreamDecoder(sink=sink, devices=["cpu"])
    for sid in files:
        hub.add_stream(sid)
    sched = _schedule(files, CHUNKINGS[chunking], order)
    for sid, piece in sched:
        hub.feed(sid, piece)
    assert ref.decode(sched).keys() == want.keys()
    for sid in files:
        hub.end_stream(sid)
    _assert_equal_to_reference(sink, want, recs)
    hub.close()


def test_feed_copies_a_buffer_its_owner_reuses(shot):
    """A receive buffer refilled after every feed (a bytearray, a writable
    memoryview of it) still gives the exact frames: feed copies what may
    change, and queues ``bytes`` and views of ``bytes`` as they are."""
    recs, files, _want = shot
    sink = Sink()
    hub = fpv_tpu_torch.MultiStreamDecoder(sink=sink, devices=["cpu"])
    rx = bytearray(257)
    for sid, data in files.items():
        hub.add_stream(sid)
        for k, piece in enumerate(_chunks(data, [257])):
            rx[: len(piece)] = piece
            whole = k % 2 and len(piece) == len(rx)
            hub.feed(sid, rx if whole else memoryview(rx)[: len(piece)])
            rx[:] = bytes(len(rx))  # the owner reuses its buffer
        hub.end_stream(sid)
    for sid in files:
        np.testing.assert_array_equal(sink.stream(sid)[0], recs[sid] << 4)
    hub.close()


def test_end_stream_retires_one_stream_while_others_go_on(shot):
    """end_stream returns with the stream's every frame delivered, frees
    its reader while another stream is mid-file, and the id is reused."""
    recs, files, want = shot
    sink = Sink()
    hub = fpv_tpu_torch.MultiStreamDecoder(sink=sink, devices=["cpu"])
    hub.add_stream("a")
    hub.add_stream("b")
    half = len(files["cam1"]) // 2
    hub.feed("b", files["cam1"][:half])
    for piece in _chunks(files["cam0"], [100]):
        hub.feed("a", piece)
    reader = weakref.ref(hub._readers["a"])
    hub.end_stream("a")
    np.testing.assert_array_equal(sink.stream("a")[0], recs["cam0"] << 4)
    gc.collect()
    assert reader() is None  # its delta planes and buffer went with it
    with pytest.raises(KeyError):
        hub.feed("a", b"x")
    hub.add_stream("a")  # the id again, another camera's file
    hub.feed("a", files["cam2"])
    hub.feed("b", files["cam1"][half:])
    hub.end_stream("b")
    hub.end_stream("a")
    np.testing.assert_array_equal(sink.stream("b")[0], recs["cam1"] << 4)
    np.testing.assert_array_equal(
        sink.stream("a")[0], np.concatenate([recs["cam0"], recs["cam2"]]) << 4)
    assert hub._readers == {}
    hub.close()


def _cut(data, where):
    """A place to cut ``data``: inside the header, the delta section or a
    batch section, or at the boundary after the first batch section."""
    dsize = int.from_bytes(data[32:40], "little")
    off, _n = tfpvt.parse_footer(data)[0]
    size = int.from_bytes(data[off : off + 8], "little")
    return {"header": 20, "delta": 32 + dsize // 2,
            "batch": off + size // 2, "boundary": off + size}[where]


@pytest.mark.parametrize("where", ["header", "delta", "batch", "boundary"])
def test_end_stream_names_a_stream_cut_inside_a_section(shot, where):
    """A stream whose bytes stop before its footer, inside a section or at
    the boundary between two, raises ValueError naming it from end_stream,
    after its complete batches reached the sink, as the plain
    demultiplexer refuses it.  The hub serves on."""
    recs, files, _want = shot
    sink = Sink()
    hub = fpv_tpu_torch.MultiStreamDecoder(sink=sink, devices=["cpu"])
    data = files["cam0"]
    hub.add_stream("cut-cam")
    hub.feed("cut-cam", data[: _cut(data, where)])
    with pytest.raises(ValueError, match="'cut-cam'.*footer"):
        hub.end_stream("cut-cam")
    delivered = {"header": 0, "delta": 0, "batch": 1, "boundary": 4}[where]
    if delivered:
        np.testing.assert_array_equal(sink.stream("cut-cam")[0],
                                      recs["cam0"][:delivered] << 4)
    else:
        assert "cut-cam" not in sink.got
    assert "cut-cam" not in hub._readers
    hub.add_stream("next")
    hub.feed("next", files["cam1"])
    hub.end_stream("next")
    np.testing.assert_array_equal(sink.stream("next")[0], recs["cam1"] << 4)
    hub.close()


def test_retired_streams_buffer_serves_the_next_stream(shot):
    """A retired stream's byte buffer holds the next stream's bytes, with
    no regrowth for a file of the same size, and every batch section parses
    into views of it (no copy a section) yet decodes pixel-exact, though
    the buffer is overwritten by later chunks and the next stream."""
    recs, files, _want = shot
    sink = Sink()
    hub = fpv_tpu_torch.MultiStreamDecoder(sink=sink, devices=["cpu"])
    before = dict(tfpvt.PARSED_STREAMS)
    hub.add_stream("a")
    for piece in _chunks(files["cam0"], [100]):
        hub.feed("a", piece)
    hub.end_stream("a")
    (buf,) = hub._spare
    hub.add_stream("b")
    assert hub._spare == [] and hub._readers["b"].buffer is buf
    for piece in _chunks(files["cam1"], [100]):
        hub.feed("b", piece)
    reader = hub._readers["b"]
    hub.end_stream("b")
    assert reader.buffer is buf
    assert hub._spare == [buf]
    got = {k: v - before[k] for k, v in tfpvt.PARSED_STREAMS.items()}
    assert got["copy"] == 0 and got["view"] > 0
    np.testing.assert_array_equal(sink.stream("a")[0], recs["cam0"] << 4)
    np.testing.assert_array_equal(sink.stream("b")[0], recs["cam1"] << 4)
    hub.close()


def test_end_stream_surfaces_a_worker_error(shot):
    """A sink that raises makes end_stream raise RuntimeError, promptly."""
    _recs, files, _want = shot

    def sink(sid, frames, ts):
        raise OSError("disk full")

    hub = fpv_tpu_torch.MultiStreamDecoder(sink=sink, devices=["cpu"])
    hub.add_stream("s")
    hub.feed("s", files["cam0"])
    with pytest.raises(RuntimeError) as info:
        hub.end_stream("s")
    assert isinstance(info.value.__cause__, OSError)


def test_counters(shot, monkeypatch):
    """batches counts the sink's calls (frame 0 included); every time is
    a wait >= 0, finalize_s at least the sink's own time."""
    import time

    _recs, files, _want = shot
    sink = Sink()

    def slow(*a):
        time.sleep(0.002)
        sink(*a)

    hub = fpv_tpu_torch.MultiStreamDecoder(sink=slow, devices=["cpu"])
    assert hub.stats() == dict(feed_wait_s=0.0, issue_idle_s=0.0,
                               fin_wait_s=0.0, finalize_s=0.0, batches=0)
    for sid, data in files.items():
        hub.add_stream(sid)
        for piece in _chunks(data, [512]):
            hub.feed(sid, piece)
    for sid in files:
        hub.end_stream(sid)
    st = hub.stats()
    sections = sum(len(tfpvt.parse_footer(d)) for d in files.values())
    assert st["batches"] == sink.calls == sections + len(files)
    assert all(st[k] >= 0 for k in ("feed_wait_s", "issue_idle_s",
                                     "fin_wait_s"))
    assert st["finalize_s"] >= 0.002 * sink.calls
    hub.close()


def test_hub_spans_and_their_threads(shot, monkeypatch):
    """feed and end_stream open their spans on the client's thread, issue
    on the stream's issue worker and finalize on the finalize worker."""
    _recs, files, _want = shot
    opened = []

    class Span:
        def __init__(self, name):
            opened.append((name, threading.get_ident()))

        def __enter__(self):
            return None

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(multistream, "annotate", Span)
    hub = fpv_tpu_torch.MultiStreamDecoder(devices=["cpu"])
    hub.add_stream("s")
    hub.feed("s", files["cam0"])
    hub.end_stream("s")
    hub.close()
    threads = {}
    for name, tid in opened:
        threads.setdefault(name, set()).add(tid)
    me = threading.get_ident()
    assert threads["fpvt.hub.feed"] == threads["fpvt.hub.end"] == {me}
    issue, fin = threads["fpvt.hub.issue"], threads["fpvt.hub.finalize"]
    assert len(issue) == len(fin) == 1 and len({me} | issue | fin) == 3


def test_many_clients_feed_and_end_at_once(shot):
    """Eight client threads, each feeding and ending its own streams, with
    the interpreter switching threads every microsecond: every stream
    exact, and no counter update lost (batches == the sink's calls)."""
    recs, files, _want = shot
    sink = Sink()
    lock = threading.Lock()

    def locked(*a):
        with lock:
            sink(*a)

    hub = fpv_tpu_torch.MultiStreamDecoder(sink=locked, devices=["cpu"])
    errors = []

    def client(k):
        try:
            for rnd in range(2):
                sid = f"c{k}.{rnd}"
                hub.add_stream(sid)
                for piece in _chunks(files[f"cam{k % 4}"], [301]):
                    hub.feed(sid, piece)
                hub.end_stream(sid)
        except Exception as e:  # reported below, with the test's failure
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in workers) and not errors, errors
    for k in range(8):
        for rnd in range(2):
            np.testing.assert_array_equal(sink.stream(f"c{k}.{rnd}")[0],
                                          recs[f"cam{k % 4}"] << 4)
    per_file = len(tfpvt.parse_footer(files["cam0"])) + 1  # + frame 0
    assert hub.stats()["batches"] == sink.calls == 16 * per_file
    hub.close()


def test_streams_are_shared_among_the_issue_workers(shot, monkeypatch):
    """Each stream goes to the issue worker serving the fewest, and every
    chunk of it is decoded on that worker's thread, in order; a retired
    stream's place goes to the next stream added.  The frames are exact."""
    recs, files, _want = shot
    seen = {}
    decode = multistream.FpvtStreamingReader.decode

    def spy(self, data):
        seen.setdefault(id(self), set()).add(threading.get_ident())
        return decode(self, data)

    monkeypatch.setattr(multistream.FpvtStreamingReader, "decode", spy)
    sink = Sink()
    hub = fpv_tpu_torch.MultiStreamDecoder(sink=sink, devices=["cpu"])
    n = multistream.ISSUE_WORKERS
    for sid in files:
        hub.add_stream(sid)
    assert sorted(hub._route[sid] for sid in files) == sorted(
        i % n for i in range(len(files)))
    readers = {sid: id(hub._readers[sid]) for sid in files}
    for sid, piece in _schedule(files, [64], "round_robin"):
        hub.feed(sid, piece)
    first = sorted(files)[0]
    w = hub._route[first]
    hub.end_stream(first)
    hub.add_stream("late")
    assert hub._route["late"] == w
    hub.feed("late", files[first])
    for sid in [*files, "late"]:
        if sid != first:
            hub.end_stream(sid)
    hub.close()
    threads = [seen[readers[sid]] for sid in files]
    assert all(len(t) == 1 for t in threads)
    assert len(set().union(*threads)) == min(n, len(files))
    for sid in files:
        np.testing.assert_array_equal(sink.stream(sid)[0], recs[sid] << 4)
    np.testing.assert_array_equal(sink.stream("late")[0], recs[first] << 4)


def test_inbox_wakes_a_blocked_feeder_at_its_low_mark():
    """A producer blocked on a full inbox stays blocked while items are
    taken down to the low mark and goes on once it is reached; items come
    out in order."""
    box = multistream._Inbox(maxsize=4, low=1)
    for i in range(4):
        box.put(i)
    done = threading.Event()

    def feed():
        box.put(4)
        done.set()

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    got = []
    for _ in range(2):  # 3 then 2 left: above the low mark
        got.append(box.get())
        assert not done.wait(0.05)
    got.append(box.get())  # 1 left: the feeder goes on
    assert done.wait(10)
    t.join(10)
    got += [box.get(), box.get()]
    assert got == [0, 1, 2, 3, 4]

"""The serving hubs and the reader hooks behind them: fpv_tpu_torch against
the JAX package.

The JAX encode hub runs on its device (pallas) engine in interpret mode
(FPV_TPU_RANS_ENGINE=pallas), once per module; its streams are
1024-lane (``narrow=False``) like the port's.  The port's hub must write
the same bytes per stream, and the port's decode hub must return JAX's
frames, timestamps and previews on those files.  Everything runs on the
CPU, where the kernel wrappers run their plain versions; every hub test
finishes in seconds (none waits on a 600 s drain).
"""

import hashlib
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

from fpv_tpu.api import fpvt_codec as jcodec
from fpv_tpu.api import multistream as jms
from fpv_tpu.utils import testdata
import fpv_tpu_torch
from fpv_tpu_torch.api import fpvt_codec as tcodec
from fpv_tpu_torch.entropy import plane_codec as tpc
from fpv_tpu_torch.format import fpvt as tfpvt
from fpv_tpu_torch.ops.rans_layout import (
    BLOCK_LANES,
    CODING_CTX16,
    CODING_ORDER0,
    CODING_RAW,
)
from fpv_tpu_torch.utils import kernels

H, W = 64, 128
HUB = dict(shift=4, frames_per_batch=3, chunk_log2=8)


def _drift_frames(n, h, w):
    """Frame t is frame 0 translated: prev-frame prediction wins."""
    pl = testdata.plasma_frames(1, h, w, bits=12, seed=3)[0]
    return np.stack(
        [np.roll(pl, (2 * i, 3 * i), (0, 1)) for i in range(n)]
    ).astype(np.uint16)


STREAMS = {
    "plasma": testdata.plasma_frames(7, H, W, bits=12, seed=1),
    "drift": _drift_frames(6, H, W),
    "noise": testdata.noise_frames(4, H, W, bits=12),
}


def _encode_hub(make_hub, streams, ts0=100):
    """Push every stream's frames interleaved (timestamps ts0 + i) through
    ``make_hub(sink)`` -> stream id -> file bytes."""
    out = {sid: [] for sid in streams}
    hub = make_hub(lambda sid, data: out[sid].append(data))
    for sid, fr in streams.items():
        hub.add_stream(sid, fr[0])
    for i in range(max(len(fr) for fr in streams.values())):
        for sid, fr in streams.items():
            if i < len(fr):
                hub.push_frame(sid, ts0 + i, fr[i])
    hub.close()
    return {sid: b"".join(parts) for sid, parts in out.items()}


@pytest.fixture(scope="module")
def hub_files():
    """(JAX hub bytes, port hub bytes) per stream."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FPV_TPU_RANS_ENGINE", "pallas")
        jax_files = _encode_hub(
            lambda sink: jms.MultiStreamEncoder(W, H, sink=sink, **HUB),
            STREAMS)
    port_files = _encode_hub(
        lambda sink: fpv_tpu_torch.MultiStreamEncoder(
            W, H, sink=sink, devices=["cpu"], **HUB),
        STREAMS)
    return jax_files, port_files


def _feed_interleaved(hub, files, piece):
    """Feed every stream's bytes in ``piece``-byte chunks, interleaved."""
    for sid in files:
        hub.add_stream(sid)
    pos = 0
    while any(pos < len(d) for d in files.values()):
        for sid, d in files.items():
            if pos < len(d):
                hub.feed(sid, d[pos : pos + piece])
        pos += piece
    hub.close()


@pytest.mark.parametrize("sid", list(STREAMS))
def test_encoder_hub_bytes_equal_jax(hub_files, sid):
    jax_files, port_files = hub_files
    assert port_files[sid] == jax_files[sid]
    np.testing.assert_array_equal(
        fpv_tpu_torch.decode_file_fpvt(port_files[sid], device="cpu"),
        STREAMS[sid] << 4)


def test_encoder_hub_streams_cover_codings(hub_files):
    """The hub's streams are 1024-lane and reach order-0, ctx16 and stored
    planes, and prev-frame prediction."""
    seen, prev = set(), False
    for data in hub_files[1].values():
        for off, _n in tfpvt.parse_footer(data):
            pb = tfpvt.parse_batch_section(data, off)
            prev |= bool((pb.frame_flags & tfpvt.F_USE_PREV).any())
            for st in (pb.high, pb.low, pb.preview):
                seen.add(st.coding)
                assert st.coding == CODING_RAW or st.lanes == BLOCK_LANES
    assert {CODING_ORDER0, CODING_CTX16, CODING_RAW} <= seen and prev


@pytest.mark.parametrize("piece", [97, 173])
def test_decoder_hub_equals_jax(hub_files, piece):
    jax_files = hub_files[0]
    got = {sid: [] for sid in jax_files}
    hub = fpv_tpu_torch.MultiStreamDecoder(
        sink=lambda sid, fr, ts: got[sid].append((fr, ts)), devices=["cpu"])
    _feed_interleaved(hub, jax_files, piece)
    for sid, data in jax_files.items():
        frames = np.concatenate([f for f, _t in got[sid]])
        np.testing.assert_array_equal(frames, jcodec.decode_file_fpvt(data))
        # hub streams code every pushed frame (no delta_is_frame0 flag)
        np.testing.assert_array_equal(
            np.concatenate([t for _f, t in got[sid]]),
            100 + np.arange(len(STREAMS[sid])))


def test_decoder_hub_previews_equal_jax(hub_files):
    jax_files = hub_files[0]
    got = {sid: [] for sid in jax_files}
    hub = fpv_tpu_torch.MultiStreamDecoder(
        sink=lambda sid, fr, ts, pv: got[sid].append((fr, pv)),
        want_previews=True, devices=["cpu"])
    _feed_interleaved(hub, jax_files, 4096)
    for sid, data in jax_files.items():
        jr = jcodec.FpvtReader(data)
        assert len(got[sid]) == jr.num_batches
        for bi, (fr, pv) in enumerate(got[sid]):
            want_fr, want_pv = jr.decode_batch_with_previews(bi)
            np.testing.assert_array_equal(fr, want_fr)
            np.testing.assert_array_equal(pv, want_pv)


def test_hubs_assign_devices_round_robin():
    """Streams go to the hub's devices in turn, on both hubs; the round
    trip stays exact.  ("cpu" and "cpu:0" are two names of the CPU, told
    apart by the device each writer and reader holds.)"""
    devices = ["cpu", "cpu:0"]
    streams = {f"cam{i}": testdata.plasma_frames(4, 32, 32, seed=20 + i)
               for i in range(4)}
    hubs = []

    def make(sink):
        hubs.append(fpv_tpu_torch.MultiStreamEncoder(
            32, 32, frames_per_batch=2, chunk_log2=8, sink=sink,
            devices=devices))
        return hubs[-1]

    files = _encode_hub(make, streams, ts0=50)
    want = [torch.device(devices[i % 2]) for i in range(4)]
    assert [w._device for w in hubs[0]._writers.values()] == want
    got = {sid: [] for sid in streams}
    dec = fpv_tpu_torch.MultiStreamDecoder(
        sink=lambda sid, fr, ts: got[sid].append(fr), devices=devices)
    _feed_interleaved(dec, files, 173)
    assert [r._device for r in dec._readers.values()] == want
    assert [r._inner._device for r in dec._readers.values()] == want
    for sid, fr in streams.items():
        np.testing.assert_array_equal(np.concatenate(got[sid]), fr)


def test_decoder_sink_error_propagates():
    """A sink that raises inside the finalize stage surfaces as a
    RuntimeError from feed()/close(), and hangs neither worker."""
    frames = testdata.plasma_frames(4, 32, 32, seed=7)
    data = fpv_tpu_torch.encode_file_fpvt(frames, frames_per_batch=2,
                                          chunk_log2=8, device="cpu")

    def sink(sid, imgs, ts):
        raise ValueError("sink boom")

    hub = fpv_tpu_torch.MultiStreamDecoder(sink=sink, devices=["cpu"])
    hub.add_stream("s")
    with pytest.raises(RuntimeError) as info:
        hub.feed("s", data)
        hub.close()
    assert isinstance(info.value.__cause__, (ValueError, RuntimeError))


def test_decoder_issue_error_stops_finalizer():
    """An issue-stage failure (a corrupt lane count in the last batch)
    delivers the finalizer its shutdown sentinel even with finalizes
    pending: close() raises promptly and no worker stays alive."""
    frames = testdata.plasma_frames(9, 32, 32, seed=9)
    data = bytearray(fpv_tpu_torch.encode_file_fpvt(
        frames, frames_per_batch=2, chunk_log2=8, device="cpu"))
    off, nfr = tfpvt.parse_footer(bytes(data))[-1]
    struct.pack_into("<H", data, off + 9 + 8 + 9 * nfr + 4 + 16, 7)

    def slow_sink(sid, imgs, ts):
        time.sleep(0.3)  # keeps the finalize queue full when the error hits

    hub = fpv_tpu_torch.MultiStreamDecoder(sink=slow_sink, devices=["cpu"])
    hub.add_stream("s")
    t0 = time.time()
    with pytest.raises(RuntimeError) as info:
        hub.feed("s", bytes(data))
        hub.close()
    assert time.time() - t0 < 60  # not the 600 s join timeout
    assert "lane count" in str(info.value.__cause__)
    for t in [*hub._workers, hub._finalizer]:
        t.join(timeout=10)
        assert not t.is_alive()


def test_encoder_worker_error_surfaces():
    """A batch the worker cannot encode (frames of the wrong size) makes
    the next push or close raise RuntimeError, and the worker ends."""
    hub = fpv_tpu_torch.MultiStreamEncoder(32, 32, frames_per_batch=2,
                                           devices=["cpu"])
    hub.add_stream("s", np.zeros((32, 32), np.uint16))
    with pytest.raises(RuntimeError) as info:
        for i in range(2):
            hub.push_frame("s", i, np.zeros((16, 16), np.uint16))
        hub.close()
    assert info.value.__cause__ is not None
    hub._worker.join(timeout=10)
    assert not hub._worker.is_alive()


@pytest.mark.parametrize("previews", [False, True])
def test_warmup_stream_runs_for_geometry(previews, monkeypatch):
    """warmup_stream encodes and decodes one batch at the geometry, with
    the previews when asked (JAX test_fpvt.py::test_warmup_stream_runs_for_
    geometry)."""
    seen = []
    real = tcodec.FpvtReader._dispatch

    def spy(self, st, want_previews, device_frames):
        seen.append((st.b, want_previews))
        return real(self, st, want_previews, device_frames)

    monkeypatch.setattr(tcodec.FpvtReader, "_dispatch", spy)
    fpv_tpu_torch.warmup_stream(32, 32, shift=4, frames_per_batch=2,
                                chunk_log2=8, previews=previews,
                                device="cpu")
    assert seen == [(2, previews)]


def test_warmup_stream_rejects_mesh():
    """``mesh=`` takes a parallel.mesh.Mesh (test_torch_parallel.py runs
    one); anything else is rejected."""
    with pytest.raises(ValueError, match="parallel/"):
        fpv_tpu_torch.warmup_stream(32, 32, device="cpu", mesh=object())


def test_warmup_frames_equal_jax():
    for shift in (0, 4, 12):
        np.testing.assert_array_equal(
            tcodec._warmup_frames(np.random.default_rng(0), 3, 8, 16, shift),
            jcodec._warmup_frames(np.random.default_rng(0), 3, 8, 16, shift))


def _narrow_file():
    frames = testdata.plasma_frames(6, 32, 32, seed=7)
    return frames, jcodec.encode_file_fpvt(frames, shift=4,
                                           frames_per_batch=2, chunk_log2=8)


@pytest.mark.parametrize("kind", ["wide", "narrow"])
def test_device_frames_sink(hub_files, kind):
    """device_frames delivers frames (int32 u16 values) and previews (u8)
    as tensors on the hub's device, equal to JAX's host decode."""
    if kind == "wide":
        data = hub_files[0]["plasma"]
    else:
        data = _narrow_file()[1]
    jr = jcodec.FpvtReader(data)
    lanes = {tfpvt.parse_batch_section(data, off).high.lanes
             for off, _n in tfpvt.parse_footer(data)}
    assert (lanes == {BLOCK_LANES}) == (kind == "wide")
    got = []
    hub = fpv_tpu_torch.MultiStreamDecoder(
        sink=lambda sid, fr, ts, pv: got.append((fr, ts, pv)),
        want_previews=True, device_frames=True, devices=["cpu"])
    hub.add_stream("s")
    hub.feed("s", data)
    hub.close()
    want_frames = jcodec.decode_file_fpvt(data)
    frames = []
    for fr, _ts, pv in got:
        assert isinstance(fr, torch.Tensor) and fr.dtype == torch.int32
        assert isinstance(pv, torch.Tensor) and pv.dtype == torch.uint8
        frames.append(fr.numpy().astype(np.uint16))
    np.testing.assert_array_equal(np.concatenate(frames), want_frames)
    pvs = [pv.numpy() for _fr, _ts, pv in got]
    if jr.header.delta_is_frame0:
        np.testing.assert_array_equal(pvs.pop(0)[0], jr.preview_frame(0))
    for bi, pv in enumerate(pvs):
        np.testing.assert_array_equal(pv, jr.decode_previews(bi))


def _count_calls(monkeypatch, owner, name):
    calls = []
    real = getattr(owner, name)

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(owner, name, spy)
    return calls


def _decode_hub(data, cache, content_ids):
    """One decode hub with a shared upload cache and device frames: each
    stream of ``content_ids`` (stream id -> content_id) is fed ``data``."""
    got = {sid: [] for sid in content_ids}
    hub = fpv_tpu_torch.MultiStreamDecoder(
        sink=lambda sid, fr, ts: got[sid].append(fr.numpy()),
        device_frames=True, upload_cache=cache, devices=["cpu"])
    for sid, cid in content_ids.items():
        hub.add_stream(sid, content_id=cid)
        hub.feed(sid, data)
    hub.close()
    return {sid: np.concatenate(v).astype(np.uint16) for sid, v in got.items()}


@pytest.mark.parametrize("content_id", [None, "blob-1"], ids=["hash", "cid"])
def test_upload_cache_hit_skips_parse_and_upload(monkeypatch, content_id):
    """A shared upload cache stages each batch once: a second hub fed the
    same bytes adds no entries, parses no batch section and uploads
    nothing; every stream decodes exactly.  Keys carry the section's hash,
    or with a content_id the id and the section's absolute offset."""
    frames, data = _narrow_file()
    want = jcodec.decode_file_fpvt(data)
    offsets = [off for off, _n in tfpvt.parse_footer(data)]
    cache: dict = {}
    got = _decode_hub(data, cache, {"a": content_id})
    np.testing.assert_array_equal(got["a"], want)
    assert len(cache) == len(offsets)
    if content_id is None:
        sections = [data[off : off + struct.unpack_from("<Q", data, off)[0]]
                    for off in offsets]
        assert sorted(cache) == sorted(
            ("sec", hashlib.blake2b(sec, digest_size=16).digest(), 32, 32, 8)
            for sec in sections)
    else:
        assert sorted(cache) == [("cid", content_id, off, 32, 32, 8)
                                 for off in offsets]
    parses = _count_calls(monkeypatch, tfpvt, "parse_batch_section")
    # a batch's staging (the delta section, staged at each stream's open
    # through the same plane_codec route, is no batch)
    stages = _count_calls(monkeypatch, tcodec.FpvtReader, "_stage")
    got = _decode_hub(data, cache, {"b": content_id, "c": content_id})
    assert (len(cache), parses, stages) == (len(offsets), [], [])
    for sid in ("b", "c"):
        np.testing.assert_array_equal(got[sid], want)


def test_random_access_reader_shares_the_upload_cache(monkeypatch):
    """FpvtReader(upload_cache=...) keys batches by their section bytes,
    as the streaming reader does: a streamed file's batches decode
    through the reader with no parse."""
    _frames, data = _narrow_file()
    cache: dict = {}
    _decode_hub(data, cache, {"a": None})
    parses = _count_calls(monkeypatch, tfpvt, "parse_batch_section")
    r = fpv_tpu_torch.FpvtReader(data, device="cpu", upload_cache=cache)
    want = jcodec.FpvtReader(data)
    for bi in range(r.num_batches):
        np.testing.assert_array_equal(r.decode_batch(bi),
                                      want.decode_batch(bi))
    assert parses == []


def test_content_id_keys_stay_absolute_past_compaction():
    """The streaming reader drops consumed bytes past 4 MiB; content_id
    keys must still carry each section's offset in the stream (the
    footer's), not its offset in the compacted buffer."""
    frames = testdata.noise_frames(13, 512, 512)
    wri = fpv_tpu_torch.FpvtWriter(512, 512, 0, False, 2, 4, device="cpu",
                                   delta_is_frame0=True, narrow=False)
    parts = [wri.init(frames[0])]
    parts += [wri.encode_batch(frames[s : s + 2]) for s in range(1, 13, 2)]
    data = b"".join(parts + [wri.finish()])
    assert len(data) > 3 << 21
    cache: dict = {}
    got = []
    sr = fpv_tpu_torch.FpvtStreamingReader(
        lambda fr, ts: got.append(fr), device="cpu", upload_cache=cache,
        content_id="long")
    for s in range(0, len(data), 1 << 20):
        sr.decode(data[s : s + (1 << 20)])
    assert sr._abs_base > 0  # the buffer was compacted
    assert sorted(k[2] for k in cache) == [
        off for off, _n in tfpvt.parse_footer(data)]
    np.testing.assert_array_equal(np.concatenate(got), frames)


def test_frame0_goes_through_batch_hook():
    """With a batch hook, the synthesized frame 0 (HDR_F_DELTA_IS_FRAME0)
    is issued like a batch: the hook gets its finalize, the callback
    nothing."""
    frames, data = _narrow_file()
    hooked, called = [], []
    sr = fpv_tpu_torch.FpvtStreamingReader(
        lambda *a: called.append(a), want_previews=True,
        batch_hook=lambda fin, ts: hooked.append((fin, ts)), device="cpu")
    sr.decode(data)
    assert called == [] and len(hooked) == 1 + len(tfpvt.parse_footer(data))
    fr, pv = hooked[0][0]()
    np.testing.assert_array_equal(hooked[0][1], [-1])
    np.testing.assert_array_equal(fr, frames[:1] << 4)
    np.testing.assert_array_equal(pv[0], jcodec.FpvtReader(data)
                                  .preview_frame(0))


def test_cuda_entry_points_need_a_card():
    """device="cuda" (the default) raises without a card; nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _frames, data = _narrow_file()
    for make in (lambda: fpv_tpu_torch.MultiStreamEncoder(32, 32),
                 lambda: fpv_tpu_torch.MultiStreamDecoder(),
                 lambda: fpv_tpu_torch.FpvtReader(data),
                 lambda: fpv_tpu_torch.FpvtStreamingReader(print),
                 lambda: fpv_tpu_torch.warmup_stream(32, 32)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.parametrize("n,limit", [(9, None), (3, 96 * 112)],
                         ids=["narrow", "wide"])
def test_file_encode_setup_equals_jax(monkeypatch, n, limit):
    """file_encode_setup makes the writer JAX's makes (header bytes, narrow
    policy from the body size, delta frame split, timestamps)."""
    frames = testdata.plasma_frames(n, 96, 112, bits=12, seed=11)
    if limit is not None:
        # over the bound JAX's writer takes its device route (pallas)
        monkeypatch.setenv("FPV_TPU_NARROW_MAX", str(limit))
        monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "pallas")
        monkeypatch.setattr(tpc, "NARROW_MAX_SYMS", limit)
    ts = np.arange(n) * 10
    jw, jhdr, jbody, jts = jcodec.file_encode_setup(frames, 4, False, 2, 8,
                                                    None, ts)
    tw, thdr, tbody, tts = tcodec.file_encode_setup(frames, 4, False, 2, 8,
                                                    None, ts, device="cpu")
    assert thdr == jhdr and tw._narrow == jw._narrow == (limit is None)
    np.testing.assert_array_equal(tbody, jbody)
    np.testing.assert_array_equal(tts, jts)


def test_kernel_library_builds_once_across_threads(monkeypatch):
    """Threads reaching the first library() together build and load once
    and all get the same library."""
    builds = []

    def slow_build():
        builds.append(1)
        time.sleep(0.05)
        return "fake.so"

    class FakeLib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    monkeypatch.setattr(kernels, "_LIB", None)
    monkeypatch.setattr(kernels, "build", slow_build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: FakeLib())
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(kernels.library()))
               for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(builds) == 1 and len(libs) == 16
    assert all(lib is libs[0] for lib in libs)
    paths = []
    threads = [threading.Thread(
        target=lambda: paths.append(kernels.library_path()))
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(paths) == 8 and len(set(paths)) == 1


def test_launch_counts_lose_no_update_across_threads(monkeypatch):
    """count_launch from more threads than cores, with a short switch
    interval: no read-modify-write is lost."""
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES,
                                                           0))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            kernels.count_launch("rans_decode") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert kernels.LAUNCHES["rans_decode"] == 16 * 2000
    kernels.reset_launches()
    assert set(kernels.LAUNCHES.values()) == {0}

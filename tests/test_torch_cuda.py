"""fpv_tpu_torch CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU (``cuda`` marker) and skip without one.  The file
imports neither JAX nor ``fpv_tpu`` so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which imports JAX.)  The plain
versions are held to the JAX package's oracles by test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import fpv_tpu_torch
from fpv_tpu_torch.entropy.tables import normalize_freqs, normalize_freqs_ctx
from fpv_tpu_torch.entropy.plane_codec import ctx_indices_device
from fpv_tpu_torch.ops import predict as tpredict
from fpv_tpu_torch.ops import rans_bound
from fpv_tpu_torch.ops import rans_cuda as tc
from fpv_tpu_torch.ops.rans_layout import BLOCK_LANES, CTX_PROB_BITS, chunk_lens
from fpv_tpu_torch.utils import testdata

LANES = BLOCK_LANES


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(n, k, ctx, seed, lanes=LANES):
    """Skewed block symbols, lane lengths and the encode/decode tables."""
    rng = np.random.default_rng(seed)
    flat = np.minimum(rng.geometric(0.3, n) - 1, 15 if ctx else 255)
    lens = chunk_lens(1, n, k, lanes)
    nb = len(lens) // lanes
    syms = np.zeros(nb * k * lanes, np.uint8)
    syms[:n] = flat
    syms = torch.from_numpy(syms.reshape(nb, k, lanes))
    if ctx:
        idx = ctx_indices_device(syms).reshape(-1)
        jhist = torch.bincount(idx, minlength=512).numpy()
        freq = normalize_freqs_ctx(jhist, floor_mask=jhist > 0)
        fc, table = tc.ctx_table_arrays(freq), tc.ctx_fused_table_arrays(freq)
    else:
        hist = np.bincount(syms.numpy().reshape(-1), minlength=256)
        freq = normalize_freqs(hist, ensure_all=True)
        fc, table = tc.table_arrays(freq), tc.fused_table_arrays(freq)
    lens_t = torch.from_numpy(lens.reshape(nb, lanes))
    return syms, lens_t, tc.u32_tensor(fc, "cpu"), tc.u32_tensor(table, "cpu")


CASES = [
    pytest.param(2 * 256 * LANES + 700, 256, False, LANES,
                 id="order0-k256-pad"),
    pytest.param(1024 * LANES + 300_001, 1024, False, LANES,
                 id="order0-k1024"),
    pytest.param(256 * LANES + 513, 256, True, LANES, id="ctx16-k256-pad"),
    pytest.param(1024 * LANES + 123_457, 1024, True, LANES, id="ctx16-k1024"),
    # narrow streams: one partial warp (8), one warp (32), several warps
    pytest.param(6144, 1024, True, 8, id="lanes8-ctx16-k1024"),
    pytest.param(2 * 16 * 8 + 5, 16, False, 8, id="lanes8-order0-k16-pad"),
    pytest.param(2048 * 32 - 77, 2048, False, 32, id="lanes32-order0-k2048"),
    pytest.param(512 * 128 + 100, 512, True, 128, id="lanes128-ctx16-pad"),
    pytest.param(3 * 64 * 512 - 9, 64, True, 512, id="lanes512-ctx16-k64"),
]


def _on_card(p, cuda):
    """A DecodePlane on the CPU -> the same on the card, its payload laid
    out as K2 stages it."""
    p = tc.DecodePlane(*(a.to(cuda) if isinstance(a, torch.Tensor) else a
                         for a in p))
    return p._replace(payload=tc.staged_payload(p.payload))


def _check_decode(cuda, planes):
    """K2 on ``planes`` (DecodePlane tuples on the CPU) in one grouped
    launch against the plain version per plane: symbols and ok flags."""
    got = tc.rans_decode_grouped([_on_card(p, cuda) for p in planes])
    for p, (g_syms, g_ok) in zip(planes, got):
        r_syms, r_ok = tc.rans_decode_ref(*p)
        torch.testing.assert_close(g_syms.cpu(), r_syms, rtol=0, atol=0)
        torch.testing.assert_close(g_ok.cpu(), r_ok, rtol=0, atol=0)
    return got


def _check_encode(cuda, planes):
    """K1a and K1b on ``planes`` (EncodePlane tuples on the CPU), each in
    one grouped launch, against their plain versions per plane; returns
    the plain (states, counts, payload) of each."""
    on_card = [tc.EncodePlane(p.syms.to(cuda), p.lens.to(cuda),
                              p.fc.to(cuda), p.prob_bits, p.ctx_mode)
               for p in planes]
    chains = tc.rans_encode_chain(on_card)
    places = tc.rans_encode_place([c[1:] for c in chains])
    out = []
    for p, chain, place in zip(planes, chains, places):
        ref = tc.rans_encode_chain_ref(*p)
        for r, g in zip(ref, chain):
            torch.testing.assert_close(g.cpu(), r, rtol=0, atol=0)
        payload = tc.rans_place_ref(ref[1], ref[2])
        torch.testing.assert_close(place.cpu(), payload, rtol=0, atol=0)
        out.append((ref[0], ref[3], payload))
    return out


def _decode_planes(enc, planes, tables):
    return [tc.DecodePlane(
        counts, torch.cumsum(counts.to(torch.int64), 0) - counts, states,
        p.lens, table, payload, p.syms.shape[1], p.prob_bits, p.ctx_mode)
        for (states, counts, payload), p, table in zip(enc, planes, tables)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,ctx,lanes", CASES)
def test_rans_kernels_match_plain(cuda, n, k, ctx, lanes):
    """K1a, K1b and K2 equal their plain versions; K2 inverts K1; a
    flipped payload word and a corrupted count decode to the plain
    version's symbols and ok flags (the flip always fails the check)."""
    syms, lens, fc, table = _case(n, k, ctx, seed=n % 97, lanes=lanes)
    pb = CTX_PROB_BITS if ctx else 12
    plane = tc.EncodePlane(syms, lens, fc, pb, ctx)
    enc = _check_encode(cuda, [plane])
    states, counts, payload = enc[0]
    torch.testing.assert_close(
        tc.rans_encode_grouped([tc.EncodePlane(
            syms.to(cuda), lens.to(cuda), fc.to(cuda), pb, ctx)])[0][2].cpu(),
        payload, rtol=0, atol=0)
    dec = _decode_planes(enc, [plane], [table])[0]
    g_syms, g_ok = _check_decode(cuda, [dec])[0]
    torch.testing.assert_close(g_syms.cpu(), syms, rtol=0, atol=0)
    assert bool((g_ok == 1).all())
    bad = payload.clone()
    bad[bad.numel() // 3] ^= 0x5A5A
    _b_syms, b_ok = _check_decode(cuda, [dec._replace(payload=bad)])[0]
    assert not bool((b_ok == 1).all())
    bad_count = counts.clone()
    bad_count[bad_count.numel() // 2] += 3
    _check_decode(cuda, [dec._replace(counts=bad_count)])


def _worst_case(lanes, k, seed):
    """Symbols of frequency 1 (of 4096) only: the most words a stream can
    carry (about 3 of every 4 steps emit a word in every active lane), so
    K2's shared window moves close to ``lanes`` words per step."""
    rng = np.random.default_rng(seed)
    freq = np.ones(256, np.int64)
    freq[0] = 4096 - 255
    lens = rng.integers(k // 2, k + 1, (2, lanes)).astype(np.int32)
    lens[:, 3] = 0  # a zero-length lane
    syms = rng.integers(1, 256, (2, k, lanes)).astype(np.uint8)
    syms[np.arange(k)[None, :, None] >= lens[:, None, :]] = 0
    return (tc.EncodePlane(torch.from_numpy(syms), torch.from_numpy(lens),
                           tc.u32_tensor(tc.table_arrays(freq), "cpu")),
            tc.u32_tensor(tc.fused_table_arrays(freq), "cpu"))


def _quiet_case(lanes, k):
    """One symbol of frequency 3841 everywhere: the state never grows past
    2^19, so no lane emits and the payload is empty."""
    freq = np.ones(256, np.int64)
    freq[0] = 4096 - 255
    syms = torch.zeros((1, k, lanes), dtype=torch.uint8)
    lens = torch.full((1, lanes), k, dtype=torch.int32)
    return (tc.EncodePlane(syms, lens,
                           tc.u32_tensor(tc.table_arrays(freq), "cpu")),
            tc.u32_tensor(tc.fused_table_arrays(freq), "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,k", [(8, 16), (32, 1024), (128, 512),
                                     (1024, 4096)])
def test_rans_kernels_worst_case_and_empty_payload(cuda, lanes, k):
    """The densest payload (the widest steps K2's shared window sees),
    zero-length lanes, and an empty payload, in one grouped launch of each
    kernel."""
    worst, w_table = _worst_case(lanes, k, seed=lanes + k)
    quiet, q_table = _quiet_case(lanes, 16)
    enc = _check_encode(cuda, [worst, quiet])
    assert enc[0][2].numel() > 0.7 * int(worst.lens.sum())
    assert enc[1][2].numel() == 0
    got = _check_decode(cuda, _decode_planes(enc, [worst, quiet],
                                             [w_table, q_table]))
    for (g_syms, g_ok), p in zip(got, (worst, quiet)):
        torch.testing.assert_close(g_syms.cpu(), p.syms, rtol=0, atol=0)
        assert bool((g_ok == 1).all())


@pytest.mark.cuda
def test_rans_grouped_launch_equals_per_plane(cuda):
    """One grouped launch of K1a, K1b and K2 over planes of different lane
    counts, chunk lengths and codings equals the plain version per plane,
    and counts one launch per pass."""
    from fpv_tpu_torch.utils import kernels

    shapes = [(2 * 256 * LANES + 700, 256, False, LANES),
              (6144, 1024, True, 8), (512 * 128 + 100, 512, True, 128),
              (2048 * 32 - 77, 2048, False, 32)]
    planes, tables = [], []
    for n, k, ctx, lanes in shapes:
        syms, lens, fc, table = _case(n, k, ctx, seed=n % 89, lanes=lanes)
        planes.append(tc.EncodePlane(syms, lens, fc,
                                     CTX_PROB_BITS if ctx else 12, ctx))
        tables.append(table)
    kernels.reset_launches()
    enc = _check_encode(cuda, planes)
    got = _check_decode(cuda, _decode_planes(enc, planes, tables))
    for (g_syms, _ok), p in zip(got, planes):
        torch.testing.assert_close(g_syms.cpu(), p.syms, rtol=0, atol=0)
    assert (kernels.LAUNCHES["rans_encode_chain"],
            kernels.LAUNCHES["rans_encode_place"],
            kernels.LAUNCHES["rans_decode"]) == (1, 1, 1)


@pytest.mark.cuda
def test_rans_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    """K1a needs chunks of at least 16 steps (its symbol rows run 16 steps
    ahead); K2 needs a staged payload, and says so rather than copying."""
    syms, lens, fc, table = _case(8 * 8, 8, False, seed=1, lanes=8)
    with pytest.raises(ValueError, match="chunk_len >= 16"):
        tc.rans_encode_chain([tc.EncodePlane(syms.to(cuda), lens.to(cuda),
                                             fc.to(cuda))])
    syms, lens, fc, table = _case(2 * 16 * 8 + 5, 16, False, seed=2, lanes=8)
    plane = tc.EncodePlane(syms, lens, fc)
    enc = _check_encode(cuda, [plane])
    dec = _on_card(_decode_planes(enc, [plane], [table])[0], cuda)
    odd = torch.zeros(dec.payload.numel() + 1, dtype=torch.int16,
                      device=cuda)[1:]
    odd.copy_(dec.payload)
    with pytest.raises(ValueError, match="staged_payload"):
        tc.rans_decode_grouped([dec._replace(payload=odd)])
    g_syms, _ok = tc.rans_decode_grouped(
        [dec._replace(payload=tc.staged_payload(odd))])[0]
    torch.testing.assert_close(g_syms.cpu(), syms, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape",
    [(2, 8, 8), (1, 1, 7), (1, 7, 1), (2, 130, 140), (3, 12, 260),
     (5, 33, 20), (4, 256, 256), (1, 4096, 64),
     # the main path's launches: the delta section, a batch's previews
     (1, 1024, 1024), (32, 256, 256),
     # K3's edges: more than one row group with a partial last group, H not
     # a multiple of 32, one column, W >> H
     (1, 1025, 5), (1, 2100, 40), (3, 45, 70), (1, 3000, 1), (2, 4, 5000)],
    ids=str,
)
def test_cg2d_kernel_matches_plain(cuda, shape):
    """K3 equals its plain version (run on the card, on the kernel's
    schedule) and the input, exactly.  Where H * W is not a multiple of
    16, the frames of a batch start at different 16-byte alignments."""
    rng = np.random.default_rng(sum(shape))
    plane = torch.from_numpy(
        rng.integers(0, 256, shape, np.int64).astype(np.uint8)
    ).to(cuda)
    res = tpredict.cg2d_encode(plane)
    got = tpredict.cg2d_decode(res)
    torch.testing.assert_close(got, tpredict.cg2d_decode_ref(res), rtol=0,
                               atol=0)
    torch.testing.assert_close(got, plane, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("start", [1, 7, 13])
def test_cg2d_kernel_on_unaligned_input(cuda, start):
    """K3 reads and writes 16-byte chunks at the rows' own alignment: a
    residual that starts off a 16-byte boundary (a contiguous view into a
    larger buffer) decodes the same."""
    rng = np.random.default_rng(start)
    plane = torch.from_numpy(
        rng.integers(0, 256, (3, 37, 53), np.int64).astype(np.uint8)
    ).to(cuda)
    res = tpredict.cg2d_encode(plane)
    buf = torch.zeros(res.numel() + 32, dtype=torch.uint8, device=cuda)
    view = buf[start : start + res.numel()].view(res.shape)
    view.copy_(res)
    torch.testing.assert_close(tpredict.cg2d_decode(view), plane, rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shift,bits", [(4, 12), (0, 16)])
def test_file_bytes_same_on_cuda_and_cpu(cuda, shift, bits):
    frames = testdata.plasma_frames(7, 64, 128, bits=bits)
    kw = dict(shift=shift, frames_per_batch=3, chunk_log2=8)
    on_card = fpv_tpu_torch.encode_file_fpvt(frames, device=cuda, **kw)
    assert on_card == fpv_tpu_torch.encode_file_fpvt(frames, device="cpu",
                                                     **kw)
    back = fpv_tpu_torch.decode_file_fpvt(on_card, device=cuda)
    np.testing.assert_array_equal(back, frames << shift)


@pytest.mark.cuda
def test_decode_frame_on_card_equals_full_decode(cuda):
    """Random access on the card: a wide file (frames spanning several
    rANS blocks, prev chains) decoded frame by frame equals its whole
    decode, with one K2 launch for each request's whole chain (none for
    frame 0, the delta frame)."""
    from fpv_tpu_torch.utils import kernels

    frames = testdata.plasma_frames(10, 128, 160, bits=12, seed=4)
    wri = fpv_tpu_torch.FpvtWriter(160, 128, 4, False, 9, 4, device=cuda,
                                   delta_is_frame0=True, narrow=False)
    data = b"".join([wri.init(frames[0]), wri.encode_batch(frames[1:]),
                     wri.finish()])
    want = fpv_tpu_torch.decode_file_fpvt(data, device=cuda)
    np.testing.assert_array_equal(want, frames << 4)
    r = fpv_tpu_torch.FpvtReader(data, device=cuda)
    kernels.reset_launches()
    for i in (9, 1, 5, 0, 8, 3):
        before = kernels.LAUNCHES["rans_decode"]
        np.testing.assert_array_equal(r.decode_frame(i), want[i])
        assert kernels.LAUNCHES["rans_decode"] - before == (i != 0), i


def _hub_streams():
    return {f"cam{i}": testdata.plasma_frames(5, 128, 160, bits=12,
                                              seed=30 + i)
            for i in range(2)}


def _hub_encode(cuda, streams):
    out = {sid: [] for sid in streams}
    hub = fpv_tpu_torch.MultiStreamEncoder(
        160, 128, shift=4, frames_per_batch=2, chunk_log2=4,
        sink=lambda sid, d: out[sid].append(d), devices=[cuda])
    for sid, fr in streams.items():
        hub.add_stream(sid, fr[0])
    for i in range(5):
        for sid, fr in streams.items():
            hub.push_frame(sid, 10 + i, fr[i])
    hub.close()
    return {sid: b"".join(parts) for sid, parts in out.items()}


@pytest.mark.cuda
def test_hub_round_trip_device_frames_on_card(cuda):
    """Encode hub -> decode hub on the card: the device_frames sink gets
    CUDA tensors (int32 frames, u8 previews) equal to the host decode, and
    the hub's bytes equal the CPU's."""
    streams = _hub_streams()
    files = _hub_encode(cuda, streams)
    for sid, fr in streams.items():
        np.testing.assert_array_equal(
            fpv_tpu_torch.decode_file_fpvt(files[sid], device=cuda), fr << 4)
    assert files == _hub_encode(torch.device("cpu"), streams)
    got = {sid: [] for sid in streams}
    hub = fpv_tpu_torch.MultiStreamDecoder(
        sink=lambda sid, fr, ts, pv: got[sid].append((fr, ts, pv)),
        want_previews=True, device_frames=True, devices=[cuda])
    for sid in streams:
        hub.add_stream(sid)
        hub.feed(sid, files[sid])
    hub.close()
    for sid, fr in streams.items():
        r = fpv_tpu_torch.FpvtReader(files[sid], device="cpu")
        assert len(got[sid]) == r.num_batches
        for bi, (frames, ts, pv) in enumerate(got[sid]):
            assert frames.is_cuda and frames.dtype == torch.int32
            assert pv.is_cuda and pv.dtype == torch.uint8
            want, want_pv = r.decode_batch_with_previews(bi)
            np.testing.assert_array_equal(
                frames.cpu().numpy().astype(np.uint16), want)
            np.testing.assert_array_equal(pv.cpu().numpy(), want_pv)
            np.testing.assert_array_equal(ts, r.timestamps(bi))


@pytest.mark.cuda
def test_hub_issue_and_finalize_use_different_streams(cuda, monkeypatch):
    """The decode hub launches every kernel on its reader's issue stream
    (not the default stream) and waits only on the reader's copy stream,
    a third one; the frames stay exact."""
    from fpv_tpu_torch.utils import kernels

    streams = _hub_streams()
    files = _hub_encode(cuda, streams)
    launched, synced = [], []
    real_launch, real_sync = kernels.launch, torch.cuda.Stream.synchronize

    def launch(name, fn_name, device, *args):
        launched.append(torch.cuda.current_stream(device).cuda_stream)
        return real_launch(name, fn_name, device, *args)

    def sync(self):
        synced.append(self.cuda_stream)
        return real_sync(self)

    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", sync)
    got = []
    hub = fpv_tpu_torch.MultiStreamDecoder(
        sink=lambda sid, fr, ts: got.append(fr), devices=[cuda])
    hub.add_stream("s")
    hub.feed("s", files["cam0"])
    hub.close()
    np.testing.assert_array_equal(np.concatenate(got),
                                  streams["cam0"] << 4)
    reader = hub._readers["s"]._inner
    issue, copy = reader._stream.cuda_stream, reader._copy_stream.cuda_stream
    default = torch.cuda.default_stream(cuda).cuda_stream
    assert len({issue, copy, default}) == 3
    assert launched and set(launched) == {issue}
    assert synced and set(synced) == {copy}


@pytest.mark.cuda
def test_hub_serves_shots_and_frees_each_ended_stream(cuda):
    """One decode hub kept open over three shots of four streams, fed in
    chunks round-robin, each stream ended: every frame exact, and the
    card's memory after the third shot no more than after the first plus
    one shot's working set (an ended stream's reader is gone)."""
    recs = [testdata.plasma_frames(7, 128, 160, bits=12, seed=50 + i)
            for i in range(4)]
    files = [fpv_tpu_torch.encode_file_fpvt(
        r, shift=4, frames_per_batch=3, chunk_log2=8, device=cuda)
        for r in recs]
    got = {}
    hub = fpv_tpu_torch.MultiStreamDecoder(
        sink=lambda sid, fr, ts: got.setdefault(sid, []).append(fr.copy()),
        devices=[cuda])

    def shot(k):
        ids = [f"cam{i}.{k}" for i in range(4)]
        for sid in ids:
            hub.add_stream(sid)
        for off in range(0, max(map(len, files)), 4096):
            for sid, data in zip(ids, files):
                if off < len(data):
                    hub.feed(sid, data[off : off + 4096])
        for sid in ids:
            hub.end_stream(sid)
        for sid, r in zip(ids, recs):
            np.testing.assert_array_equal(np.concatenate(got.pop(sid)),
                                          r << 4)

    torch.cuda.synchronize(cuda)
    before = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    shot(0)
    torch.cuda.synchronize(cuda)
    working = torch.cuda.max_memory_allocated(cuda) - before
    after_first = torch.cuda.memory_allocated(cuda)
    shot(1)
    shot(2)
    torch.cuda.synchronize(cuda)
    assert torch.cuda.memory_allocated(cuda) <= after_first + working
    assert hub.stats()["batches"] == 3 * 4 * 3  # frame 0 + 2 batches each
    hub.close()


@pytest.mark.cuda
def test_mutation_fuzz_on_card_then_clean_decode(cuda):
    """Single-byte mutations and truncations of a wide file (some forcing
    CG2D frames, so K3 runs on garbage) decode or raise ValueError on the
    card, and a clean decode afterwards is exact: the CUDA context
    survives."""
    import struct

    from fpv_tpu_torch.format import fpvt as tfpvt
    from fpv_tpu_torch.utils import kernels

    frames = testdata.plasma_frames(5, 128, 160, bits=12, seed=8)
    wri = fpv_tpu_torch.FpvtWriter(160, 128, 4, False, 2, 4, device=cuda,
                                   delta_is_frame0=True, narrow=False)
    data = b"".join([wri.init(frames[0])]
                    + [wri.encode_batch(frames[s : s + 2]) for s in (1, 3)]
                    + [wri.finish()])
    mutants = []
    for off, n in tfpvt.parse_footer(data):
        for j in range(n):  # frame flags: spatial bits -> CG2D
            m = bytearray(data)
            m[off + 17 + j] = (m[off + 17 + j] & ~6) | 4
            mutants.append(bytes(m))
        m = bytearray(data)  # a high-plane count
        nfr = struct.unpack_from("<I", data, off + 9)[0]
        pos = off + 17 + 9 * nfr
        nch = struct.unpack_from("<I", data, pos + 12)[0]
        struct.pack_into("<I", m, pos + 24 + 512 + 4 * nch, 5)
        mutants.append(bytes(m))
    rng = np.random.default_rng(11)
    for _ in range(60):
        m = bytearray(data)
        m[int(rng.integers(0, len(m)))] ^= int(rng.integers(1, 256))
        mutants.append(bytes(m))
    mutants += [data[: int(c)] for c in rng.integers(0, len(data), 15)]
    kernels.reset_launches()
    for m in mutants:
        try:
            fpv_tpu_torch.decode_file_fpvt(m, device=cuda)
            r = fpv_tpu_torch.FpvtReader(m, device=cuda)
            for bi in range(r.num_batches):
                r.decode_batch_with_previews(bi)
        except ValueError:
            pass
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rans_decode"] and kernels.LAUNCHES["cg2d_decode"]
    np.testing.assert_array_equal(
        fpv_tpu_torch.decode_file_fpvt(data, device=cuda), frames << 4)


# -- the FPV1 profile: K4 (flat CG inverse), the device filter chain ------


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape",
    [(3, 1, 1), (2, 1, 9), (2, 2, 7), (3, 9, 1), (1, 3, 5), (2, 6, 5),
     # the serial walk's widest, the scan's narrowest, partial segments
     (1, 40, 63), (2, 65, 64), (1, 9, 64), (1, 70, 200),
     # a grown preview buffer (56 entries at stride 7: 8 rows) and the
     # card check's batch
     (1, 8, 7), (4, 256, 256)],
    ids=str,
)
def test_cg_flat_kernel_matches_plain(cuda, shape):
    """K4 equals its plain version (run on the card) and inverts the flat
    CG residual, exactly; random residuals too."""
    from fpv_tpu_torch.models import predictors as tpred

    rng = np.random.default_rng(sum(shape))
    plane = torch.from_numpy(
        rng.integers(0, 256, shape, np.int64).astype(np.uint8)).to(cuda)
    res = tpred.cg_flat_encode(plane)
    got = tpred.cg_flat_decode(res)
    torch.testing.assert_close(got, tpred.cg_flat_decode_ref(res), rtol=0,
                               atol=0)
    torch.testing.assert_close(got, plane, rtol=0, atol=0)
    if plane.numel() <= 4096:
        noise = torch.from_numpy(
            rng.integers(0, 256, shape, np.int64).astype(np.uint8)).to(cuda)
        torch.testing.assert_close(tpred.cg_flat_decode(noise),
                                   tpred.cg_flat_decode_ref(noise), rtol=0,
                                   atol=0)


@pytest.mark.cuda
def test_cg_flat_kernel_full_frames_and_unaligned_input(cuda):
    """K4 on two 1024^2 frames inverts the residual; a residual that starts
    off a 16-byte boundary decodes the same."""
    from fpv_tpu_torch.models import predictors as tpred
    from fpv_tpu_torch.utils import kernels

    rng = np.random.default_rng(1)
    plane = torch.from_numpy(
        rng.integers(0, 256, (2, 1024, 1024), np.int64).astype(np.uint8)
    ).to(cuda)
    kernels.reset_launches()
    torch.testing.assert_close(
        tpred.cg_flat_decode(tpred.cg_flat_encode(plane)), plane, rtol=0,
        atol=0)
    assert kernels.LAUNCHES["cg_flat_decode"] == 1
    small = plane[:, :37, :53].contiguous()
    res = tpred.cg_flat_encode(small)
    buf = torch.zeros(res.numel() + 32, dtype=torch.uint8, device=cuda)
    view = buf[5 : 5 + res.numel()].view(res.shape)
    view.copy_(res)
    torch.testing.assert_close(tpred.cg_flat_decode(view), small, rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape",
    [# the serial walk's last width, the scan's first, one above (L = 8)
     (2, 50, 63), (2, 50, 64), (2, 50, 65),
     # X = L - 1, L, L + 1 for a full tile's L = 32 (serial walk), and for
     # the L = 12 of 100 to 144 columns (one segment of 12 short or over)
     (3, 40, 31), (3, 40, 32), (3, 40, 33), (2, 30, 131), (2, 30, 132),
     (2, 30, 133),
     # a tile of 1024 columns: one short, one over (a second, 1-pixel tile)
     (2, 30, 1023), (2, 30, 1025),
     # rows wider than a tile: chunks in 40 tiles chained through phase B
     (1, 4, 40000),
     # the most frames a launch splits over clusters of 8 CTAs, one more
     (16, 64, 1024), (17, 64, 1024),
     # the format's tallest frame, the delta frame, the FPV1 decode batch
     (1, 65536, 64), (1, 1024, 1024), (63, 1024, 1024)],
    ids=str,
)
def test_cg_flat_scan_edges(cuda, shape):
    """K4's scan at its edges and at the main path's shapes: exact against
    the input before ``cg_flat_encode`` and against the plain version (on
    the leading 4096 rows of the tallest frame: a row never depends on a
    later one, and the plain version steps once per segment in Python);
    random residuals too."""
    from fpv_tpu_torch.models import predictors as tpred

    rng = np.random.default_rng(sum(shape))
    plane = torch.from_numpy(
        rng.integers(0, 256, shape, np.int64).astype(np.uint8)).to(cuda)
    noise = torch.from_numpy(
        rng.integers(0, 256, shape, np.int64).astype(np.uint8)).to(cuda)
    res = tpred.cg_flat_encode(plane)
    got = tpred.cg_flat_decode(res)
    torch.testing.assert_close(got, plane, rtol=0, atol=0)
    rows = min(shape[1], 4096)
    for inp, out in ((res, got), (noise, tpred.cg_flat_decode(noise))):
        head = inp[:, :rows].contiguous()
        torch.testing.assert_close(out[:, :rows], tpred.cg_flat_decode_ref(
            head), rtol=0, atol=0)


@pytest.mark.cuda
def test_fpv1_filter_chain_on_card_equals_cpu(cuda):
    """split, decision histograms, delta and CG residuals and previews of a
    batch on the card equal the CPU's; unpredict (K4) inverts them."""
    from fpv_tpu_torch.api import frame as tframe
    from fpv_tpu_torch.models import heuristics as theur

    frames = testdata.plasma_frames(6, 96, 128, bits=12, seed=3)
    frames[2] = 0x123  # constant: entropy 0, no delta, no CG
    outs = []
    for dev in ("cpu", cuda):
        imgs = torch.from_numpy(frames.view(np.int16)).to(dev)
        imgs = imgs.to(torch.int32) & 0xFFFF
        planes = tframe.split_planes(imgs[1:], 4, False)
        delta = tframe.split_planes(imgs[:1], 4, False)
        delta = tframe.FramePlanes(high=delta.high[0], low=delta.low[0])
        counts = theur.decision_counts(planes.high, planes.high - delta.high)
        p = tframe.predict(planes, delta)
        back = tframe.unpredict(p, delta)
        outs.append([counts.cpu(), p.flags, p.high.cpu(), p.low.cpu(),
                     p.preview.cpu(), back.high.cpu(), back.low.cpu()])
    cpu, card = outs
    assert cpu[1] == card[1]
    for a, b in zip(cpu[:1] + cpu[2:], card[:1] + card[2:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    hi = torch.from_numpy((frames[1:] << 4 >> 8).astype(np.uint8))
    torch.testing.assert_close(card[5], hi, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shift,bits,big_endian", [(4, 12, False),
                                                   (0, 16, True),
                                                   (8, 8, False)])
def test_fpv1_round_trip_on_card(cuda, shift, bits, big_endian):
    """FPV1 on the card: the bytes equal the CPU's (held to the JAX
    package's by test_torch_fpv1.py); decode_file, the streaming decoder
    and random access with previews return the frames; K4 ran."""
    from fpv_tpu_torch.utils import kernels

    frames = testdata.plasma_frames(7, 64, 96, bits=bits, seed=2)
    kw = dict(shift=shift, big_endian=big_endian, num_threads=2)
    kernels.reset_launches()
    on_card = fpv_tpu_torch.encode_file(frames, device=cuda, **kw)
    assert on_card == fpv_tpu_torch.encode_file(frames, device="cpu", **kw)
    want = fpv_tpu_torch.decode_file(on_card, device="cpu")
    np.testing.assert_array_equal(
        fpv_tpu_torch.decode_file(on_card, num_threads=3, device=cuda), want)
    got = []
    sd = fpv_tpu_torch.StreamingDecoder(device=cuda)
    for s in range(0, len(on_card), 1000):
        sd.decode(on_card[s : s + 1000],
                  lambda ok, f, xs, ys, p: got.append(f) if ok else None)
    np.testing.assert_array_equal(np.stack(got), want)
    ra = fpv_tpu_torch.RandomAccessDecoder(device=cuda)
    rc = fpv_tpu_torch.RandomAccessDecoder(device="cpu")
    assert ra.init(on_card) and rc.init(on_card)
    for i in (6, 0, 3):
        np.testing.assert_array_equal(ra.decode_frame(i), want[i])
        np.testing.assert_array_equal(ra.decode_preview(i),
                                      rc.decode_preview(i))
    assert kernels.LAUNCHES["cg_flat_decode"] > 0


def _fpv1_cg(data: bytes) -> tuple[bool, list[bool]]:
    """An FPV1 file's CG flags: (delta frame, [each frame])."""
    from fpv_tpu_torch.format import container

    cg = fpv_tpu_torch.FrameFlags.USE_CG
    return bool(data[13] & cg), [
        bool(data[container.parse_frame_chunk(data, off).main_start] & cg)
        for off in container.parse_footer(data)]


@pytest.mark.cuda
def test_transcode_round_trip_on_card(cuda):
    """FPV1 -> FPVT -> FPV1 on the card returns the input; both directions
    write the CPU's bytes (held to the JAX package's by
    test_torch_transcode.py); one K4 launch per FPVT batch (frame 0 decodes
    with the first) plus the delta frame's, one K2 per batch plus the
    delta section's."""
    from fpv_tpu_torch.utils import kernels

    frames = testdata.plasma_frames(9, 64, 128, bits=12, seed=4)
    fpv1 = fpv_tpu_torch.encode_file(frames, shift=4, device="cpu")
    kw = dict(shift=4, frames_per_batch=3)
    kernels.reset_launches()
    fpvt = fpv_tpu_torch.transcode_to_fpvt(fpv1, device=cuda, **kw)
    torch.cuda.synchronize()
    k4 = kernels.LAUNCHES["cg_flat_decode"]
    assert fpvt == fpv_tpu_torch.transcode_to_fpvt(fpv1, device="cpu", **kw)
    delta_cg, cg = _fpv1_cg(fpv1)
    batches = [cg[0:4], cg[4:7], cg[7:9]]  # frame 0 rides with batch 0
    assert k4 == delta_cg + sum(any(b) for b in batches) and k4 > 1
    np.testing.assert_array_equal(
        fpv_tpu_torch.decode_file_fpvt(fpvt, device=cuda), frames << 4)
    kernels.reset_launches()
    back = fpv_tpu_torch.transcode_to_fpv1(fpvt, device=cuda)
    torch.cuda.synchronize()
    assert back == fpv1
    from fpv_tpu_torch.format import fpvt as tfpvt

    _f, dh, dl = tfpvt.parse_delta_section(fpvt, tfpvt.HEADER_SIZE)
    sections = [(dh, dl)] + [
        (pb.high, pb.low) for pb in (tfpvt.parse_batch_section(fpvt, off)
                                     for off, _n in tfpvt.parse_footer(fpvt))]
    assert kernels.LAUNCHES["rans_decode"] == sum(
        any(st is not None and st.coding in (0, 1) for st in sec)
        for sec in sections)


@pytest.mark.cuda
def test_columnar_decode_on_card_one_k4_per_batch(cuda):
    """Columnar on the card: the batches equal the CPU encoder's, each
    ImageType decodes to the CPU's images with one K4 launch per batch
    holding a CG frame (or CG preview)."""
    from fpv_tpu_torch.batch import columnar as tcol
    from fpv_tpu_torch.utils import kernels

    frames = testdata.plasma_frames(12, 64, 96, bits=12, seed=3)

    def encode(dev):
        out = []
        enc = tcol.ColumnarBatchEncoder(96, 64, 4, False,
                                        lambda b: out.append(b) if b else None,
                                        frames_per_batch=5, device=dev)
        for i in range(len(frames)):
            enc.push_frame(i, frames[i]).result(timeout=60)
        enc.join()
        return out

    card, cpu = encode(cuda), encode("cpu")
    for a, b in zip(card, cpu):
        assert a.length == b.length
        np.testing.assert_array_equal(a._buffer, b._buffer)
    for type in tcol.ImageType:
        kernels.reset_launches()
        got = [img for b in card for img in b.extract_images(type, cuda)]
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["cg_flat_decode"] == sum(
            any(f & fpv_tpu_torch.FrameFlags.USE_CG
                for f in b._flags[: b.length]) for b in card)
        want = [img for b in cpu for img in b.extract_images(type, "cpu")]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.data, w.data)
    full = [img for b in card for img in b.extract_images(tcol.ImageType.FULL)]
    for img, f in zip(full, frames):
        np.testing.assert_array_equal(img.data16().reshape(64, 96), f << 4)


@pytest.mark.cuda
def test_arrow_round_trip_on_card(cuda):
    pytest.importorskip("pyarrow")
    from fpv_tpu_torch.batch import arrow as tarrow

    frames = testdata.plasma_frames(5, 48, 64, bits=12, seed=6)
    out = {}
    for dev in (cuda, "cpu"):
        rbs = []
        enc = tarrow.ArrowEncoder(64, 48, 4, False,
                                  lambda rb: rbs.append(rb) if rb else None,
                                  frames_per_batch=3, device=dev)
        for i in range(len(frames)):
            enc.push_frame(i, frames[i]).result(timeout=60)
        enc.join()
        out[str(dev)] = rbs
    for a, b in zip(out[str(cuda)], out["cpu"]):
        assert a.equals(b) and a.schema.equals(b.schema, check_metadata=True)
    got = [f for rb in out[str(cuda)]
           for f in tarrow.decode_record_batch(rb, device=cuda)]
    np.testing.assert_array_equal(np.stack(got), frames << 4)


@pytest.mark.cuda
def test_cli_on_card_writes_the_cpu_bytes(cuda, tmp_path):
    """``python -m fpv_tpu_torch.cli.encode`` with ``--device cuda`` writes
    the bytes ``--device cpu`` writes, in both profiles; decode and
    ``inspect --check`` run on the card."""
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    raw = testdata.to_raw_bytes(
        testdata.plasma_frames(5, 64, 128, bits=12, seed=5), shift=4)

    def run(tool, args, stdin, device):
        return subprocess.run(
            [sys.executable, "-m", f"fpv_tpu_torch.cli.{tool}", *args,
             "--device", device], input=stdin, capture_output=True,
            check=True, cwd=repo).stdout

    for profile in ("fpv1", "fpvt"):
        args = ["128", "64", "0", "4", "2", "--profile", profile]
        data = run("encode", args, raw, "cuda")
        assert data == run("encode", args, raw, "cpu")
        assert run("decode", ["128", "64", "0", "4"], data, "cuda") == raw
        path = tmp_path / profile
        path.write_bytes(data)
        assert run("inspect", ["--check", str(path)], b"", "cuda").endswith(
            b"check: ok (all batches decode)\n")


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2], ids=["d1", "d2-logical"])
def test_sharded_file_round_trip_on_card(cuda, monkeypatch, shards):
    """``sharded_encode_file`` / ``sharded_decode_file`` over D shards of
    the one card (D = 2: two logical shards, each on its own stream): the
    file equals ``encode_file_fpvt``'s on the card, the decode is
    pixel-exact, and both launch what the single-device calls launch."""
    from fpv_tpu_torch.entropy import plane_codec
    from fpv_tpu_torch.parallel import mesh as tmesh
    from fpv_tpu_torch.utils import kernels

    monkeypatch.setattr(plane_codec, "NARROW_MAX_SYMS", 0)
    frames = testdata.plasma_frames(1 + 2 * 2 * 4 + 3, 64, 128, bits=12,
                                    seed=6)
    kw = dict(shift=4, frames_per_batch=4, chunk_log2=8)
    mesh = tmesh.make_mesh(devices=[cuda] * shards)

    def counted(fn):
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(kernels.LAUNCHES)

    want, l_want = counted(lambda: fpv_tpu_torch.encode_file_fpvt(
        frames, device=cuda, **kw))
    got, l_got = counted(lambda: tmesh.sharded_encode_file(frames, mesh,
                                                           **kw))
    assert got == want and l_got == l_want
    assert l_got["rans_encode_chain"] == 5 + 2  # 5 batches + 2 delta planes
    back, l_dec = counted(lambda: fpv_tpu_torch.decode_file_fpvt(
        want, device=cuda))
    out, l_out = counted(lambda: tmesh.sharded_decode_file(want, mesh))
    np.testing.assert_array_equal(out, frames << 4)
    np.testing.assert_array_equal(out, back)
    assert l_out == l_dec and l_out["rans_decode"] == 5 + 1
    out, pv = tmesh.sharded_decode_file(want, mesh, want_previews=True)
    np.testing.assert_array_equal(out, frames << 4)
    r = fpv_tpu_torch.FpvtReader(want, device=cuda)
    np.testing.assert_array_equal(pv, np.concatenate(
        [r.preview_frame(0)[None]]
        + [r.decode_batch_with_previews(i)[1]
           for i in range(r.num_batches)]))


@pytest.mark.cuda
def test_sharded_codec_roundtrip_on_card(cuda):
    """The full codec over two logical shards of the card: one grouped K1a,
    K1b and K2 launch per shard, ok, pixel-exact (left-aligned)."""
    from fpv_tpu_torch.parallel import mesh as tmesh
    from fpv_tpu_torch.utils import kernels

    frames = testdata.plasma_frames(9, 128, 160, bits=12, seed=7)
    left = frames[0].astype(np.uint32) << 4
    step = tmesh.sharded_codec_roundtrip(
        tmesh.make_mesh(devices=[cuda, cuda]), chunk_len=256, shift=4)
    kernels.reset_launches()
    out, ok = step(frames[1:], (left >> 8) & 0xFF, left & 0xFF)
    assert ok
    np.testing.assert_array_equal(out, frames[1:] << 4)
    assert [kernels.LAUNCHES[k] for k in ("rans_encode_chain",
                                          "rans_encode_place",
                                          "rans_decode")] == [2, 2, 2]
    tmesh.multichip_dryrun(2, mesh=tmesh.make_mesh(devices=[cuda, cuda]))


@pytest.mark.cuda
@pytest.mark.parametrize("key", sorted(tc.VARIANTS),
                         ids=[rans_bound.variant_label(k)
                              for k in sorted(tc.VARIANTS)])
def test_decode_variant_matches_plain(cuda, key):
    """Every K2 variant on the card (csrc/rans_decode_variants.cu) equals
    its plain version bit for bit, on 3 blocks (which nsub 2, 4 and 8 do
    not divide) with a short last lane; the class, two-table, precision
    and nsub variants decode the stream as K2 does."""
    planes, flags, want = rans_bound.variant_case(key)
    got = tc.rans_decode_variant([_on_card(p, cuda) for p in planes],
                                 **flags)
    for p, (g_syms, g_ok) in zip(planes, got):
        r_syms, r_ok = tc.rans_decode_variant_ref(*p, **flags)
        torch.testing.assert_close(g_syms.cpu(), r_syms, rtol=0, atol=0)
        torch.testing.assert_close(g_ok.cpu(), r_ok, rtol=0, atol=0)
        if want is not None:
            torch.testing.assert_close(g_syms.cpu(), want, rtol=0, atol=0)
            assert bool((g_ok == 1).all())


@pytest.mark.cuda
def test_decode_variant_refuses_what_is_not_built(cuda):
    """A combination the card has no kernel for, narrow blocks and a
    table of the wrong size raise before any launch."""
    planes, flags, _w = rans_bound.variant_case(
        (False, False, False, 2, 12, True, 1))
    p = _on_card(planes[0], cuda)
    with pytest.raises(ValueError, match="no K2 variant"):
        tc.rans_decode_variant([p], stub_window=True)
    with pytest.raises(ValueError, match="table entries"):
        tc.rans_decode_variant([p], stub_class=3)
    syms, lens, fc, table = _case(6144, 1024, False, 1, lanes=32)
    enc = _check_encode(cuda, [tc.EncodePlane(syms, lens, fc)])
    narrow = _on_card(_decode_planes(enc, [tc.EncodePlane(syms, lens, fc)],
                                     [table])[0], cuda)
    with pytest.raises(ValueError, match="64 lanes"):
        tc.rans_decode_variant([narrow], nsub=2)


@pytest.mark.cuda
@pytest.mark.parametrize("nsub", [2, 4, 8])
@pytest.mark.parametrize("ctx", [False, True], ids=["order0", "ctx16"])
def test_encode_chain_nsub_equals_k1a(cuda, ctx, nsub):
    """K1a with nsub chains per thread writes K1a's states, words, ballots
    and counts bit for bit, on 3 blocks (padded to a multiple of nsub)."""
    syms, lens, fc, _table = _case(3 * 64 * LANES - 500, 64, ctx, seed=nsub)
    pb = CTX_PROB_BITS if ctx else 12
    plane = tc.EncodePlane(syms.to(cuda), lens.to(cuda), fc.to(cuda), pb,
                           ctx)
    ref = tc.rans_encode_chain([plane])[0]
    got = tc.rans_encode_chain([plane], nsub=nsub)[0]
    plain = tc.rans_encode_chain_ref(syms, lens, fc, pb, ctx)
    for g, r, q in zip(got, ref, plain):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
        torch.testing.assert_close(g.cpu(), q, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the module-level decode API (fused_decode_batch, fused_decode_frame,
# fused_decode_preview, sharded_fused_decode) on the card against the CPU

DECODE_ARGS = ("payload", "plane_offs", "counts", "states", "flags",
               "sym_tabs", "fcs")
API_FILES = {
    "plasma-ctx16": (lambda: testdata.plasma_frames(7, 64, 128, bits=12),
                     4, 3),
    "plasma-order0": (lambda: testdata.plasma_frames(5, 256, 256, bits=16,
                                                     seed=2), 0, 2),
    "repeated-const": (lambda: np.repeat(testdata.plasma_frames(
        1, 32, 64, bits=12, seed=3), 5, axis=0), 4, 2),
    "noise-raw": (lambda: testdata.noise_frames(5, 32, 64), 0, 2),
}


def _api_file(name, dev, monkeypatch):
    """A fused-geometry file of API_FILES[name] written on ``dev``, and
    its frames << shift."""
    from fpv_tpu_torch.entropy import plane_codec

    monkeypatch.setattr(plane_codec, "NARROW_MAX_SYMS", 0)
    make, shift, fpb = API_FILES[name]
    frames = make()
    data = fpv_tpu_torch.encode_file_fpvt(frames, shift=shift,
                                          frames_per_batch=fpb, chunk_log2=8,
                                          device=dev)
    return data, frames.astype(np.uint16) << shift


def _api_batch(r, arrays, static, n, **kw):
    from fpv_tpu_torch.api.fpvt_codec import fused_decode_batch

    return fused_decode_batch(
        *[arrays[a] for a in DECODE_ARGS], r._delta_high, r._delta_low,
        arrays["const_vals"], chunk_len=1 << r.header.chunk_log2, b=n,
        h=r.header.ysize, w=r.header.xsize, **static, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(API_FILES))
def test_fused_decode_batch_on_card(cuda, monkeypatch, name):
    """``batch_decode_args`` + ``fused_decode_batch`` on the card equal the
    CPU's outputs and the reader's frames and previews, numpy or staged
    tensor inputs, previews and ``pack_u8`` on and off; each call launches
    K2 once when it has a coded plane and K3 as its CG2D flags ask."""
    from fpv_tpu_torch.api.fpvt_codec import batch_decode_args
    from fpv_tpu_torch.utils import kernels

    data, want = _api_file(name, cuda, monkeypatch)
    r = fpv_tpu_torch.FpvtReader(data, device=cuda)
    rc = fpv_tpu_torch.FpvtReader(data, device="cpu")
    start = 1
    for bi, (off, n) in enumerate(r._batches):
        arrays, static = batch_decode_args(r._parse_batch(off),
                                           1 << r.header.chunk_log2)
        _f, want_pv = rc.decode_batch_with_previews(bi)
        staged = {k: torch.from_numpy(v).to(cuda) for k, v in arrays.items()}
        for pv in (False, True):
            for pack in (False, True):
                coded = [i for i in range(2 + pv)
                         if not (static["const_planes"][i]
                                 or static["raw_planes"][i])]
                k3 = int(static["any_cg"]) + int(pv and static["pv_any_cg"])
                cpu = _api_batch(rc, arrays, static, n, decode_preview=pv,
                                 pack_u8=pack)
                for inputs in (arrays, staged):
                    kernels.reset_launches()
                    got = _api_batch(r, inputs, static, n, decode_preview=pv,
                                     pack_u8=pack)
                    torch.cuda.synchronize()
                    assert kernels.LAUNCHES["rans_decode"] == int(bool(coded))
                    assert kernels.LAUNCHES["cg2d_decode"] == k3
                    assert all(g.device.type == "cuda" for g in got)
                    for g, c in zip(got, cpu):
                        assert torch.equal(g.cpu(), c)
                assert bool(got[1])
                frames = got[0].cpu().numpy()
                if pack:
                    frames = frames.view("<u2").reshape(n, *want.shape[1:])
                np.testing.assert_array_equal(frames, want[start : start + n])
                if pv:
                    np.testing.assert_array_equal(got[2].cpu().numpy(),
                                                  want_pv)
        start += n


@pytest.mark.cuda
def test_fused_decode_frame_and_preview_on_card(cuda, monkeypatch):
    """``fused_decode_frame`` (walking prev chains with the previous
    frame's planes, as the JAX reader does) and ``fused_decode_preview``
    on the card equal ``decode_frame`` and ``decode_previews``, one K2
    launch a call, K3 on CG2D frames and previews.  The file's second
    batch stores its low plane RAW: its frames take no fused frame decode
    (the JAX reader decodes that batch whole), and ``_frame_decode_args``
    says so."""
    from fpv_tpu_torch.api.fpvt_codec import (
        _frame_decode_args,
        _preview_decode_args,
        fused_decode_frame,
        fused_decode_preview,
    )
    from fpv_tpu_torch.format.fpvt import (
        F_PV_SPATIAL_SHIFT,
        F_SPATIAL_SHIFT,
        F_USE_PREV,
        SPATIAL_CG2D,
    )
    from fpv_tpu_torch.ops.rans_layout import CODING_RAW
    from fpv_tpu_torch.utils import kernels

    data, want = _api_file("plasma-order0", cuda, monkeypatch)
    r = fpv_tpu_torch.FpvtReader(data, device=cuda)
    h, w, k = r.header.ysize, r.header.xsize, 1 << r.header.chunk_log2
    raw_low = r._parse_batch(r._batches[1][0])
    assert raw_low.low.coding == CODING_RAW
    with pytest.raises(ValueError, match="coded 1024-lane"):
        _frame_decode_args(raw_low, 0, h, w, k)
    for index in range(1, 1 + r._batches[0][1]):
        bi, j = r._frame_to_batch[index]
        pb = r._parse_batch(r._batches[bi][0])
        j0 = j
        while j0 > 0 and pb.frame_flags[j0] & F_USE_PREV:
            j0 -= 1
        dh, dl = r._delta_high, r._delta_low
        for t in range(j0, j + 1):
            args, kw = _frame_decode_args(pb, t, h, w, k)
            kernels.reset_launches()
            img, ok = fused_decode_frame(*args, dh, dl, **kw)
            torch.cuda.synchronize()
            assert bool(ok) and kernels.LAUNCHES["rans_decode"] == 1
            assert kernels.LAUNCHES["cg2d_decode"] == int(
                ((pb.frame_flags[t] >> F_SPATIAL_SHIFT) & 3) == SPATIAL_CG2D)
            dh, dl = (img >> 8).to(torch.uint8), (img & 0xFF).to(torch.uint8)
        np.testing.assert_array_equal(img.cpu().numpy(), want[index])
        np.testing.assert_array_equal(img.cpu().numpy(), r.decode_frame(index))
    for bi in range(r.num_batches):
        pb = r._parse_batch(r._batches[bi][0])
        args, kw = _preview_decode_args(pb, h, w)
        kernels.reset_launches()
        pv, ok = fused_decode_preview(*args, r._delta_high, **kw)
        torch.cuda.synchronize()
        assert bool(ok) and kernels.LAUNCHES["rans_decode"] == 1
        assert kernels.LAUNCHES["cg2d_decode"] == int(bool(
            (((pb.frame_flags >> F_PV_SPATIAL_SHIFT) & 3)
             == SPATIAL_CG2D).any()))
        np.testing.assert_array_equal(pv.cpu().numpy(), r.decode_previews(bi))


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2], ids=["d1", "d2-logical"])
def test_sharded_fused_decode_on_card(cuda, monkeypatch, shards):
    """``sharded_fused_decode`` over D shards of the card: equal to the
    per-section ``fused_decode_batch(pack_u8=True)`` calls and to the CPU's
    two-shard run, one K2 launch a shard."""
    from fpv_tpu_torch.parallel import mesh as tmesh
    from fpv_tpu_torch.utils import kernels

    data, want = _api_file("plasma-ctx16", cuda, monkeypatch)
    r = fpv_tpu_torch.FpvtReader(data, device=cuda)
    rc = fpv_tpu_torch.FpvtReader(data, device="cpu")
    h, w, k = r.header.ysize, r.header.xsize, 1 << r.header.chunk_log2
    pbs = [r._parse_batch(off) for off, _n in r._batches[:shards]]
    n = r._batches[0][1]
    stack, static = tmesh.stack_decode_args(pbs, k)
    outs = {}
    for dev, rdr in ((cuda, r), (torch.device("cpu"), rc)):
        mesh = tmesh.make_mesh(devices=[dev] * shards)
        step = tmesh.sharded_fused_decode(mesh, chunk_len=k, b=n, h=h, w=w,
                                          decode_preview=True, **static)
        kernels.reset_launches()
        outs[dev.type] = step(*[stack[a] for a in DECODE_ARGS],
                              rdr._delta_high, rdr._delta_low,
                              stack["const_vals"])
        torch.cuda.synchronize()
        if dev.type == "cuda":
            assert kernels.LAUNCHES["rans_decode"] == shards
    for g, c in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(g.cpu(), c)
    for i in range(shards):
        one = _api_batch(r, {key: v[i] for key, v in stack.items()}, static,
                         n, decode_preview=True, pack_u8=True)
        for g, o in zip(outs["cuda"], one):
            assert torch.equal(g[i], o)
        frames = outs["cuda"][0][i].cpu().numpy().view("<u2").reshape(n, h, w)
        np.testing.assert_array_equal(frames,
                                      want[1 + i * n : 1 + (i + 1) * n])


@pytest.mark.cuda
def test_reader_spans_on_the_kernels_clock(cuda):
    """In a traced decode the reader's spans and the kernels share the
    profiler's clock: every batch's K2 starts after its batch's
    ``fpvt.read.dispatch`` opened.  The spans are host operations, so
    kineto puts no copy of them on the card's timeline: the window's busy
    time is that of its kernels, copies and sets alone."""
    from fpvbench import trace as tracing

    frames = testdata.plasma_frames(33, 256, 256, bits=12)
    data = fpv_tpu_torch.encode_file_fpvt(frames, shift=4,
                                          frames_per_batch=8, device=cuda)
    fpv_tpu_torch.decode_file_fpvt(data, device=cuda)  # warm
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(tracing.WINDOW):
            out = fpv_tpu_torch.decode_file_fpvt(data, device=cuda)
        torch.cuda.synchronize()
    np.testing.assert_array_equal(out, frames << 4)
    tr = tracing.from_profiler(prof)
    dispatch = sorted(h.start for h in tr.host
                      if h.name == "fpvt.read.dispatch")
    k2 = sorted(d.start for d in tr.device
                if "rans_decode_kernel" in d.name)
    assert len(dispatch) == 4 and len(k2) >= len(dispatch)
    # a batch's K2 after its dispatch opened and before the next one did
    batch_k2 = k2[len(k2) - len(dispatch):]
    assert all(d <= k for d, k in zip(dispatch, batch_k2))
    assert all(k < d for k, d in zip(batch_k2, dispatch[1:]))
    on_card = [e for e in prof.profiler.kineto_results.events()
               if str(e.device_type()).endswith("CUDA")]
    assert not [e.name() for e in on_card if e.name().startswith("fpvt.")]
    # the seconds as from_profiler reckons them, so the sums agree exactly
    work = [tracing.Interval(e.name(), e.start_ns() / 1e9,
                             e.start_ns() / 1e9 + e.duration_ns() / 1e9,
                             "kernel")
            for e in on_card if e.name() != tracing.WINDOW]
    assert tr.busy_s() == sum(
        b - a for a, b in tracing.busy_intervals(work, tr.window))
    print(f"reader spans: busy {tr.busy_s()} s of {tr.window_s} s, "
          f"{len(tr.kernels())} kernels")


def _reader_parts(data, cuda):
    """Frame 0 and every batch's ``decode_batch`` on the card, joined."""
    r = fpv_tpu_torch.FpvtReader(data, device=cuda)
    parts = [r.frame0()[None]] if r.header.delta_is_frame0 else []
    return np.concatenate(
        parts + [r.decode_batch(i) for i in range(r.num_batches)])


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, 1], ids=["pinned", "over-cap"])
def test_decode_file_downloads_into_one_output_on_card(cuda, monkeypatch,
                                                       cap):
    """decode_file_fpvt downloads every batch (the last one partial) and
    frame 0 into one output: page-locked from torch's host cache under
    the cap, pageable over it, the same bytes as the reader's parts."""
    from fpv_tpu_torch.api import fpvt_codec as tcodec

    if cap is not None:
        monkeypatch.setattr(tcodec, "PINNED_OUTPUT_MAX_BYTES", cap)
    frames = testdata.plasma_frames(9, 128, 160, bits=16, seed=11)
    data = fpv_tpu_torch.encode_file_fpvt(frames, frames_per_batch=3,
                                          device=cuda)  # batches 3, 3, 2
    before = dict(tcodec.DECODE_FILE_OUTPUTS)
    got = fpv_tpu_torch.decode_file_fpvt(data, device=cuda)
    took = "pageable" if cap is not None else "pinned"
    assert tcodec.DECODE_FILE_OUTPUTS[took] == before[took] + 1
    assert sum(tcodec.DECODE_FILE_OUTPUTS.values()) == sum(
        before.values()) + 1
    assert torch.from_numpy(got).is_pinned() == (cap is None)
    assert got.dtype == np.uint16 and got.flags.c_contiguous
    assert got.flags.writeable
    assert got.tobytes() == _reader_parts(data, cuda).tobytes()
    np.testing.assert_array_equal(got, frames)


@pytest.mark.cuda
def test_decode_file_output_is_not_reused_while_held(cuda):
    """A held output keeps its pinned block: decoding other files of the
    same size, whose outputs come from torch's host cache and go back to
    it, never writes into it."""
    import gc

    shape = (9, 128, 160)
    fa = testdata.plasma_frames(*shape, bits=12, seed=21)
    fb = testdata.plasma_frames(*shape, bits=12, seed=22)
    da, db = (fpv_tpu_torch.encode_file_fpvt(f, shift=4, frames_per_batch=4,
                                             device=cuda) for f in (fa, fb))
    a = fpv_tpu_torch.decode_file_fpvt(da, device=cuda)
    gc.collect()  # the reader and its streams are gone
    for _ in range(2):
        b = fpv_tpu_torch.decode_file_fpvt(db, device=cuda)
        assert not np.shares_memory(a, b)
        np.testing.assert_array_equal(b, fb << 4)
        del b
        gc.collect()
    np.testing.assert_array_equal(a, fa << 4)


@pytest.mark.cuda
@pytest.mark.parametrize("shift,bits", [(0, 16), (4, 12)])
def test_decode_file_parses_views_on_card(cuda, shift, bits):
    """decode_file_fpvt on the card of a 1024-lane file (batches of 3, 3
    and 2 frames) equals the CPU decode; its parse takes every coded and
    RAW plane stream as a view of the file's bytes and copies none."""
    from fpv_tpu_torch.format import fpvt

    frames = testdata.plasma_frames(9, 128, 160, bits=bits, seed=23)
    wri = fpv_tpu_torch.FpvtWriter(160, 128, shift, False, 3, 12,
                                   device=cuda, delta_is_frame0=True,
                                   narrow=False)
    data = b"".join([wri.init(frames[0])]
                    + [wri.encode_batch(frames[s : s + 3])
                       for s in range(1, 9, 3)] + [wri.finish()])
    _df, dh, dl = fpvt.parse_delta_section(bytearray(data), fpvt.HEADER_SIZE)
    streams = [dh, dl]
    for off, _n in fpvt.parse_footer(data):
        pb = fpvt.parse_batch_section(bytearray(data), off)
        streams += [pb.high, pb.low, pb.preview]
    coded = sum(st is not None and st.coding != fpvt.CODING_CONST
                for st in streams)
    assert coded >= 8
    before = dict(fpvt.PARSED_STREAMS)
    got = fpv_tpu_torch.decode_file_fpvt(data, device=cuda)
    assert fpvt.PARSED_STREAMS == {"view": before["view"] + coded,
                                   "copy": before["copy"]}
    np.testing.assert_array_equal(
        got, fpv_tpu_torch.decode_file_fpvt(data, device="cpu"))
    np.testing.assert_array_equal(got, frames << shift)

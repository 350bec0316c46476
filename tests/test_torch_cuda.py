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
from fpv_tpu_torch.ops import rans_cuda as tc
from fpv_tpu_torch.ops.rans_layout import BLOCK_LANES, CTX_PROB_BITS, chunk_lens
from fpv_tpu_torch.utils import testdata

LANES = BLOCK_LANES


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(n, k, ctx, seed):
    """Skewed block symbols, lane lengths and the encode/decode tables."""
    rng = np.random.default_rng(seed)
    flat = np.minimum(rng.geometric(0.3, n) - 1, 15 if ctx else 255)
    lens = chunk_lens(1, n, k)
    nb = len(lens) // LANES
    syms = np.zeros(nb * k * LANES, np.uint8)
    syms[:n] = flat
    syms = torch.from_numpy(syms.reshape(nb, k, LANES))
    if ctx:
        idx = ctx_indices_device(syms).reshape(-1)
        jhist = torch.bincount(idx, minlength=512).numpy()
        freq = normalize_freqs_ctx(jhist, floor_mask=jhist > 0)
        fc, table = tc.ctx_table_arrays(freq), tc.ctx_fused_table_arrays(freq)
    else:
        hist = np.bincount(syms.numpy().reshape(-1), minlength=256)
        freq = normalize_freqs(hist, ensure_all=True)
        fc, table = tc.table_arrays(freq), tc.fused_table_arrays(freq)
    lens_t = torch.from_numpy(lens.reshape(nb, LANES))
    return syms, lens_t, tc.u32_tensor(fc, "cpu"), tc.u32_tensor(table, "cpu")


CASES = [
    pytest.param(2 * 256 * LANES + 700, 256, False, id="order0-k256-pad"),
    pytest.param(1024 * LANES + 300_001, 1024, False, id="order0-k1024"),
    pytest.param(256 * LANES + 513, 256, True, id="ctx16-k256-pad"),
    pytest.param(1024 * LANES + 123_457, 1024, True, id="ctx16-k1024"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,ctx", CASES)
def test_rans_kernels_match_plain(cuda, n, k, ctx):
    syms, lens, fc, table = _case(n, k, ctx, seed=n % 97)
    pb = CTX_PROB_BITS if ctx else 12
    ref = tc.rans_encode_ref(syms, lens, fc, pb, ctx)
    got = tc.rans_encode(syms.to(cuda), lens.to(cuda), fc.to(cuda), pb, ctx)
    for r, g in zip(ref, got):
        torch.testing.assert_close(g.cpu(), r, rtol=0, atol=0)
    states, counts, payload = ref
    starts = torch.cumsum(counts.to(torch.int64), 0) - counts
    for flip in (False, True):
        pay = payload.clone()
        if flip:
            pay[pay.numel() // 3] ^= 0x5A5A
        args = (counts, starts, states, lens, table, pay)
        r_syms, r_ok = tc.rans_decode_ref(*args, k, pb, ctx)
        g_syms, g_ok = tc.rans_decode(*(a.to(cuda) for a in args), k, pb,
                                      ctx)
        torch.testing.assert_close(g_syms.cpu(), r_syms, rtol=0, atol=0)
        torch.testing.assert_close(g_ok.cpu(), r_ok, rtol=0, atol=0)
        assert bool(r_ok.all()) != flip
        if not flip:
            torch.testing.assert_close(r_syms, syms, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape",
    [(2, 8, 8), (1, 1, 7), (1, 7, 1), (2, 130, 140), (3, 12, 260),
     (5, 33, 20), (4, 256, 256), (1, 4096, 64)],
    ids=str,
)
def test_cg2d_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    plane = torch.from_numpy(
        rng.integers(0, 256, shape, np.int64).astype(np.uint8)
    )
    res = tpredict.cg2d_encode(plane)
    got = tpredict.cg2d_decode(res.to(cuda)).cpu()
    torch.testing.assert_close(got, tpredict.cg2d_decode_ref(res), rtol=0,
                               atol=0)
    torch.testing.assert_close(got, plane, rtol=0, atol=0)


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

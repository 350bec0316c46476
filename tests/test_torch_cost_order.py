"""Decision costs summed in the JAX package's float32 order.

The JAX model step sums its decision costs (wraparound magnitudes of
mod-256 residuals) in float32.  On the CPU, XLA's TreeReductionRewriter
turns each sum into reduce-windows of 32 with "same" padding, level by
level, then a sequential sum of the last partials.  Past 2^24 the rounding
depends on that order, and near-tied costs can flip a per-frame decision.
The port rebuilds the order (``fpvt_codec._run_sums``/``_tree_f32``);
these tests hold it to ``jax.jit`` of the JAX sums bit for bit, and pin the
near-tie inputs on which an exact sum chose differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpv_tpu.api import fpvt_codec as jcodec
from fpv_tpu.entropy import tables as jtables
from fpv_tpu.entropy import tables_device as jtd
from fpv_tpu.ops import planes as jplanes
import fpv_tpu_torch
from fpv_tpu_torch.api import fpvt_codec as tcodec
from fpv_tpu_torch.format import fpvt as tfpvt
from fpv_tpu_torch.ops.rans_layout import CODING_RAW
from fpv_tpu_torch.parallel import mesh as tmesh

DECISIONS = ("use_delta", "use_prev", "spatial", "pv_spatial",
             "pv_use_delta", "nonzero_low")


@jax.jit
def _jax_cost(x):
    """The JAX model step's spatial ``_cost``: float32 sums per frame."""
    xi = x.astype(jnp.int32).reshape(x.shape[0], -1)
    return jnp.sum(jnp.minimum(xi, 256 - xi).astype(jnp.float32), axis=1)


@pytest.mark.parametrize("shape", [(1, 4096, 4096), (4, 2048, 2048),
                                   (2, 1000, 3000), (2, 4100, 4000),
                                   (1, 16, 70000), (3, 65, 33)])
def test_cost_sums_follow_the_xla_tree_order(shape):
    """Random planes (sums past 2^24 at the larger shapes, odd sizes that
    pad each tree level): the port's costs equal ``jax.jit`` of the JAX
    sums bit for bit, where the exact sum cast to float32 does not."""
    rng = np.random.default_rng(sum(shape))
    exact_differs = 0
    for _ in range(3):
        plane = rng.integers(0, 256, shape, dtype=np.uint8)
        ref = np.asarray(jax.jit(jcodec._residual_cost)(jnp.asarray(plane)))
        got = tcodec._residual_cost(torch.from_numpy(plane)).numpy()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            tcodec._cost(torch.from_numpy(plane)).numpy(),
            np.asarray(_jax_cost(jnp.asarray(plane))))
        mags = tcodec._mags(tcodec._sample_rows_rotating(
            torch.from_numpy(plane), 16))
        exact = mags.sum(dim=1, dtype=torch.int64).to(torch.float32).numpy()
        exact_differs += int((exact != ref).sum())
    if shape in ((1, 4096, 4096), (2, 4100, 4000)):
        assert exact_differs  # the order matters at these sizes


def _near_tie(seed: int, k: int):
    """One 4096^2 frame of 16-bit noise and a delta frame of zeros with k
    pixels of row 0 set to 256, at the first columns whose high byte is in
    1..128: each lowers the static-delta cost by one below the none cost."""
    frames = np.random.default_rng(seed).integers(
        0, 1 << 16, (1, 4096, 4096), dtype=np.uint16)
    hb = frames[0, 0] >> 8
    cols = np.nonzero((hb >= 1) & (hb <= 128))[0][:k]
    delta = np.zeros((4096, 4096), np.uint16)
    delta[0, cols] = 256
    return frames, delta


# (seed, lowered pixels, JAX's use_delta): the inputs on which the exact
# int64 sum chose otherwise
NEAR_TIES = [(1, 1, False), (1, 2, False), (1, 3, False), (1, 4, False),
             (1, 5, False), (0, 3, True), (0, 4, True), (0, 5, True),
             (0, 6, True), (2, 1, True)]


@pytest.mark.parametrize("seed,k,use_delta", NEAR_TIES)
def test_near_tie_decisions_equal_jax(seed, k, use_delta):
    """The single-device and the row-sharded model steps decide as JAX's
    ``encode_model_step`` on the near-tie inputs."""
    frames, delta = _near_tie(seed, k)
    dh, dl, _nz = jplanes.split_planes(delta[None], 0, False)
    ref = jcodec.encode_model_step(
        jnp.asarray(frames), dh[0], dl[0], shift=0, big_endian=False,
        use_delta_frame=True, low_ctx=False, allow_prev=False)
    assert bool(ref["use_delta"][0]) is use_delta
    imgs = torch.from_numpy(frames.view(np.int16)).to(torch.int32) & 0xFFFF
    dht, dlt = torch.from_numpy(np.array(dh[0])), torch.from_numpy(
        np.array(dl[0]))
    got = tcodec.encode_model_step(imgs, dht, dlt, 0, False, True, False,
                                   False)
    mesh = tmesh.make_mesh(2, data=1, space=2,
                           devices=[torch.device("cpu")] * 2)
    sharded = tmesh.sharded_encode_model_step(mesh)(frames, dht, dlt)
    for name in DECISIONS:
        want = np.asarray(ref[name]).astype(np.int64)
        np.testing.assert_array_equal(got[name].numpy().astype(np.int64),
                                      want, err_msg=name)
        np.testing.assert_array_equal(
            sharded[name].numpy().astype(np.int64), want, err_msg=name)


def test_near_tie_file_flags_and_streams():
    """The 4096^2 input of seed 1 with one lowered pixel, through the
    port's file writer (shift 0, defaults): frame flags 18 (delta off), as
    JAX writes them.  The high and low planes are stored RAW; the preview
    stream's table is the JAX device normalizer's (the table of the JAX
    fused program the port's wide route mirrors).  The JAX package's numpy
    engine, its CPU default, normalizes that histogram on the host into a
    table differing in some entries, so its file (34,335,321 bytes) and
    the port's (34,335,665) differ in the preview stream alone."""
    frames, delta = _near_tie(1, 1)
    data = fpv_tpu_torch.encode_file_fpvt(frames, shift=0,
                                          delta_frame=delta, device="cpu")
    assert len(data) == 34_335_665
    off, n = tfpvt.parse_footer(data)[0]
    pb = tfpvt.parse_batch_section(data, off)
    assert n == 1 and pb.frame_flags.tolist() == [18]
    assert pb.high.coding == pb.low.coding == CODING_RAW
    dh, dl, _nz = jplanes.split_planes(delta[None], 0, False)
    m = jcodec.encode_model_step(
        jnp.asarray(frames), dh[0], dl[0], shift=0, big_endian=False,
        use_delta_frame=True, low_ctx=False, allow_prev=True)
    flags = jcodec.FpvtWriter._pack_flags(
        *(np.asarray(m[k]) for k in ("use_delta", "spatial", "pv_spatial",
                                     "nonzero_low", "pv_use_delta",
                                     "use_prev")))
    assert flags.tolist() == [18]
    hist, mask = np.asarray(m["hist_preview"]), np.asarray(m["mask_preview"])
    device_table = np.asarray(jtd.normalize_freqs_device(jnp.asarray(hist),
                                                         jnp.asarray(mask)))
    np.testing.assert_array_equal(pb.preview.freq, device_table)
    host_table = jtables.normalize_freqs(hist, floor_mask=mask)
    assert (host_table != device_table).any()

"""The FPVT device geometry as a whole: fpv_tpu_torch against the JAX
package.

The JAX reference files are written on the device (pallas) engine in
interpret mode with narrow streams off (FPV_TPU_RANS_ENGINE=pallas,
FPV_TPU_NARROW_MAX=0); the port writes the same geometry through
``FpvtWriter(..., narrow=False)``.  The port's bytes must equal them
exactly, the port must decode them pixel-exact, and the JAX reader must
decode the port's files.  Each JAX file is built once per module
(interpret-mode kernels cost seconds).  The default (narrow-policy) file
API is held to the JAX package in test_torch_file_api.py.
"""

import struct
import os
import subprocess
import sys
import pathlib

import numpy as np
import pytest

from fpv_tpu.api import fpvt_codec as jcodec
from fpv_tpu.utils import testdata
import fpv_tpu_torch
from fpv_tpu_torch.format import fpvt as tfpvt
from fpv_tpu_torch.ops.rans_layout import (
    CODING_CONST,
    CODING_CTX16,
    CODING_ORDER0,
    CODING_RAW,
)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _repeated(n, h, w):
    f = testdata.plasma_frames(1, h, w, bits=12, seed=3)
    return np.repeat(f, n, axis=0)


# name -> (frames, shift, codings the batch sections must use)
CASES = {
    "plasma-ctx16": (lambda: testdata.plasma_frames(7, 64, 128, bits=12),
                     4, {CODING_ORDER0, CODING_CTX16}),
    "plasma-order0": (lambda: testdata.plasma_frames(7, 64, 128, bits=16),
                      0, {CODING_ORDER0}),
    "repeated-const": (lambda: _repeated(5, 32, 64), 4, {CODING_CONST}),
    "noise-raw": (lambda: testdata.noise_frames(5, 32, 64), 0, {CODING_RAW}),
}
ENC = dict(frames_per_batch=3, chunk_log2=8)


def _port_wide(frames, shift, frames_per_batch, chunk_log2):
    """encode_file_fpvt's layout (frame 0 is the delta section) through a
    writer with the narrow policy off: every batch takes the fused
    1024-lane route."""
    n, h, w = frames.shape
    wri = fpv_tpu_torch.FpvtWriter(
        w, h, shift, False, frames_per_batch, chunk_log2, device="cpu",
        delta_is_frame0=True, narrow=False,
    )
    parts = [wri.init(frames[0])]
    for s in range(1, n, frames_per_batch):
        parts.append(wri.encode_batch(frames[s : s + frames_per_batch]))
    return b"".join(parts + [wri.finish()])


@pytest.fixture(scope="module")
def files():
    """name -> (frames, shift, JAX bytes, port bytes)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FPV_TPU_RANS_ENGINE", "pallas")
        mp.setenv("FPV_TPU_NARROW_MAX", "0")
        for name, (make, shift, _codings) in CASES.items():
            frames = make()
            jax_bytes = jcodec.encode_file_fpvt(frames, shift=shift, **ENC)
            port = _port_wide(frames, shift, **ENC)
            out[name] = (frames, shift, jax_bytes, port)
    return out


def _codings(data: bytes) -> set:
    out = set()
    for off, _n in tfpvt.parse_footer(data):
        pb = tfpvt.parse_batch_section(data, off)
        out |= {st.coding for st in (pb.high, pb.low) if st is not None}
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_port_bytes_equal_jax_device_writer(files, name):
    _frames, _shift, jax_bytes, port = files[name]
    assert port == jax_bytes
    assert CASES[name][2] <= _codings(port)


@pytest.mark.parametrize("name", list(CASES))
def test_port_decodes_jax_file(files, name):
    frames, shift, jax_bytes, _port = files[name]
    got = fpv_tpu_torch.decode_file_fpvt(jax_bytes, device="cpu")
    np.testing.assert_array_equal(got, frames << shift)


@pytest.mark.parametrize("name", list(CASES))
def test_jax_decodes_port_file(files, name):
    frames, shift, _jax_bytes, port = files[name]
    got = jcodec.decode_file_fpvt(port)
    np.testing.assert_array_equal(got, frames << shift)


def test_port_decodes_jax_numpy_engine_file(monkeypatch):
    """The JAX numpy engine's 1024-lane writer builds its ctx16 tables from
    an exact histogram (other tables, other bytes); the port must still
    decode its files pixel-exact."""
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "numpy")
    monkeypatch.setenv("FPV_TPU_NARROW_MAX", "0")
    frames = testdata.plasma_frames(9, 48, 96, bits=12, seed=21)
    data = jcodec.encode_file_fpvt(frames, shift=4, **ENC)
    got = fpv_tpu_torch.decode_file_fpvt(data, device="cpu")
    np.testing.assert_array_equal(got, frames << 4)


def _stream_offsets(data: bytes, off: int) -> list[int]:
    """Byte offsets of a batch section's plane streams."""
    nframes = struct.unpack_from("<I", data, off + 9)[0]
    pos = off + 9 + 8 + 9 * nframes
    out = []
    for _ in range(3):
        out.append(pos)
        pos += struct.unpack_from("<I", data, pos)[0]
    return out


def test_corrupted_payload_raises(files):
    data = bytearray(files["plasma-ctx16"][3])
    off, _n = tfpvt.parse_footer(bytes(data))[0]
    pb = tfpvt.parse_batch_section(bytes(data), off)
    payload = pb.high.payload.tobytes()
    at = bytes(data).find(payload, off)
    assert at > 0 and pb.high.coding == CODING_ORDER0
    data[at + len(payload) // 2] ^= 0xFF
    with pytest.raises(ValueError, match="integrity"):
        fpv_tpu_torch.decode_file_fpvt(bytes(data), device="cpu")


@pytest.mark.parametrize("chunk_len", [0, 24])
def test_bad_preview_chunk_len_rejected(files, chunk_len):
    data = bytearray(files["plasma-ctx16"][3])
    off, _n = tfpvt.parse_footer(bytes(data))[0]
    pv = _stream_offsets(bytes(data), off)[2]
    struct.pack_into("<I", data, pv + 8, chunk_len)
    with pytest.raises(ValueError, match="chunk length"):
        fpv_tpu_torch.decode_file_fpvt(bytes(data), device="cpu")


def test_narrow_stream_decodes():
    """The golden fixtures are small files whose streams are narrow."""
    data = (REPO / "tests" / "golden" / "v6_drift.fpvt").read_bytes()
    off, _n = tfpvt.parse_footer(data)[0]
    assert tfpvt.parse_batch_section(data, off).high.lanes < 1024
    with np.load(REPO / "tests" / "golden" / "inputs.npz") as z:
        want = z["drift"] << 4
    got = fpv_tpu_torch.decode_file_fpvt(data, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_import_leaves_out_jax_and_fpv_tpu():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import fpv_tpu_torch, fpv_tpu_torch.utils.testdata\n"
        "import fpv_tpu_torch.utils.kernels, fpv_tpu_torch.ops.rans_cuda\n"
        "import fpv_tpu_torch.api.multistream\n"
        "import fpv_tpu_torch.api.encoder, fpv_tpu_torch.api.decoder\n"
        "import fpv_tpu_torch.api.frame, fpv_tpu_torch.format.container\n"
        "import fpv_tpu_torch.format.bits, fpv_tpu_torch.entropy.brotli\n"
        "import fpv_tpu_torch.models.heuristics\n"
        "import fpv_tpu_torch.models.predictors\n"
        "import fpv_tpu_torch.api.transcode, fpv_tpu_torch.utils.platform\n"
        "import fpv_tpu_torch.cli.encode, fpv_tpu_torch.cli.decode\n"
        "import fpv_tpu_torch.cli.inspect, fpv_tpu_torch.cli.benchmark\n"
        "import fpv_tpu_torch.cli.transcode, fpv_tpu_torch.batch.columnar\n"
        "import fpv_tpu_torch.parallel.mesh\n"
        "import fpv_tpu_torch.parallel.distributed\n"
        "import fpv_tpu_torch.utils.profiling\n"
        "import fpv_tpu_torch.ops.rans_bound\n"
        "import fpv_tpu_torch.studies.temporal_study\n"
        "import fpv_tpu_torch.studies.class_tables_study\n"
        "import fpv_tpu_torch.studies.ctx_study\n"
        "import fpv_tpu_torch.studies.large_frame_study\n"
        "import importlib.util\n"
        "if importlib.util.find_spec('pyarrow'):\n"
        "    import fpv_tpu_torch.batch.arrow\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'fpv_tpu', 'fpv_native'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, check=True,
    )
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("script", ["time_rans.py", "time_cg2d.py"])
def test_timing_scripts_run_as_files(script, tmp_path):
    """``PYTHONPATH=<checkout> python3 fpv_tpu_torch/utils/<script>`` (how
    two trees are timed in one call) imports: the script's own directory,
    whose platform.py would shadow the standard library's, is left off
    the path.  Without a card the script then stops at its device check."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run in full")
    out = subprocess.run(
        [sys.executable, str(REPO / "fpv_tpu_torch" / "utils" / script)],
        cwd=tmp_path, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode != 0
    assert "torch.cuda.is_available() is false" in out.stderr, out.stderr

"""The golden wire-format fixtures through fpv_tpu_torch alone.

``tests/golden/`` holds FPVT files written by the JAX package's historical
(v4, v5) and current (v6) writers from the inputs in ``inputs.npz``, and
the SHA-256 pins of the current writer's output.  The port must decode
every fixture pixel-exact and its default writer must reproduce both
pins.  No JAX is needed: on a machine with a card this file runs with
``--noconftest`` like test_torch_cuda.py.
"""

import hashlib
import json
import pathlib

import numpy as np
import pytest

import fpv_tpu_torch

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


@pytest.fixture(scope="module")
def golden_inputs():
    with np.load(GOLDEN / "inputs.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize(
    "name,key,shift",
    [("v4.fpvt", "drift", 4), ("v5.fpvt", "drift", 4),
     ("v6_drift.fpvt", "drift", 4), ("v6_raw.fpvt", "noise16", 0)],
)
def test_port_decodes_golden_fixture(golden_inputs, name, key, shift):
    data = (GOLDEN / name).read_bytes()
    got = fpv_tpu_torch.decode_file_fpvt(data, device="cpu")
    np.testing.assert_array_equal(got, golden_inputs[key] << shift)


@pytest.mark.parametrize(
    "name,key,shift",
    [("v6_drift.fpvt", "drift", 4), ("v6_raw.fpvt", "noise16", 0)],
)
def test_port_writer_matches_golden_pin(golden_inputs, name, key, shift):
    with open(GOLDEN / "hashes.json") as f:
        pins = json.load(f)
    data = fpv_tpu_torch.encode_file_fpvt(
        golden_inputs[key], shift=shift, frames_per_batch=4, chunk_log2=8,
        device="cpu",
    )
    assert hashlib.sha256(data).hexdigest() == pins[name]


def test_port_fpv1_writer_matches_golden_pin(golden_inputs):
    """The FPV1 fixture's inputs re-encode to its pin (the JAX package's
    bytes; the system libbrotli at quality 1)."""
    with open(GOLDEN / "hashes.json") as f:
        pins = json.load(f)
    data = fpv_tpu_torch.encode_file(golden_inputs["drift"], shift=4,
                                     num_threads=0, device="cpu")
    assert hashlib.sha256(data).hexdigest() == pins["v1_drift.fpv"]

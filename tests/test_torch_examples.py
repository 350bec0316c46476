"""The fpv_tpu_torch.examples scripts must stay runnable (they are
documentation): each runs as ``python -m fpv_tpu_torch.examples.<name>
--device cpu`` and asserts what its JAX script asserts (lossless, and
byte-identical where the JAX script says so)."""

import os
import subprocess
import sys

import pytest

from conftest import REPO


@pytest.mark.parametrize(
    "name,last",
    [("fpv1_compat", "ok"), ("fpvt_pipeline", "totals:"),
     ("serving_hubs", "served losslessly"),
     ("multichip", "sharded encode byte-identical")],
)
def test_example_runs(name, last):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    p = subprocess.run(
        [sys.executable, "-m", f"fpv_tpu_torch.examples.{name}",
         "--device", "cpu"],
        capture_output=True, cwd=REPO, env=env, timeout=600,
    )
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    assert last in p.stdout.decode().strip().splitlines()[-1]


def test_example_needs_a_card_unless_asked_for_the_cpu():
    """Without ``--device cpu`` and without a card, an example exits 1
    with the reason and runs nothing on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    p = subprocess.run(
        [sys.executable, "-m", "fpv_tpu_torch.examples.fpvt_pipeline"],
        capture_output=True, cwd=REPO, env=env, timeout=120,
    )
    assert p.returncode == 1
    assert b"no CUDA device" in p.stderr
    assert p.stdout == b""

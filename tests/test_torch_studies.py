"""``fpv_tpu_torch.studies`` against the JAX package's ``examples/``.

Each study's ``study()`` runs at the ``--fast`` size (4 frames of 128^2)
on every corpus of its ``main`` on the CPU, beside the JAX example loaded
from ``examples/`` by path: the same dict, key for key and number for
number (the same integer residuals give the same entropies).
``large_frame_study`` at ``--fast --chunks 9,10`` writes files of the
JAX study's sizes.
"""

import importlib.util
import sys

import pytest

from conftest import REPO
from fpv_tpu_torch.studies import (
    class_tables_study,
    ctx_study,
    large_frame_study,
    temporal_study,
)


def _example(name: str):
    """``examples/<name>.py`` as a module (class_tables_study imports
    temporal_study from its own directory)."""
    examples = str(REPO / "examples")
    if examples not in sys.path:
        sys.path.insert(0, examples)
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CASES = [(mod, corpus) for mod in (temporal_study, class_tables_study,
                                   ctx_study) for corpus in mod.CORPORA]


@pytest.mark.parametrize(
    "mod,corpus", CASES,
    ids=[f"{m.__name__.rsplit('.', 1)[1]}-{c}" for m, c in CASES])
def test_study_equals_jax_example(mod, corpus):
    name = mod.__name__.rsplit(".", 1)[1]
    jax_mod = _example(name)
    [(_n, frames, shift)] = temporal_study.corpora(4, 128, (corpus,))
    got = mod.study(corpus, frames, shift, device="cpu")
    want = jax_mod.study(corpus, frames, shift)
    assert got == want


def test_corpora_are_the_examples():
    """The shared corpora draw what each example's main draws."""
    import numpy as np

    from fpv_tpu.utils import testdata

    n, d = 4, 32
    rng = np.random.default_rng(0)
    pl = testdata.plasma_frames(n, d, d, bits=12, seed=5).astype(np.int32)
    dark = rng.poisson(50, (n, d, d)).astype(np.uint16)
    dark[rng.random((n, d, d)) < 1e-4] = 4000
    mixed = np.clip(pl + rng.normal(0, 8, pl.shape), 0, 4095).astype(
        np.uint16)
    got = dict((name, (f, s)) for name, f, s in
               temporal_study.corpora(n, d, temporal_study.CORPORA))
    np.testing.assert_array_equal(got["dark12"][0], dark)
    np.testing.assert_array_equal(got["mixed12"][0], mixed)
    np.testing.assert_array_equal(got["pan12"][0],
                                  _example("temporal_study").pan_frames(n, d))
    assert got["noise16"][1] == 0 and got["plasma12s"][1] == 4


def test_large_frame_study_fast_equals_jax_file_sizes(monkeypatch):
    """The port's ``FpvtWriter(narrow=False)`` is the JAX writer on its
    Pallas engine (the fused 1024-lane route the study targets)."""
    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "pallas")
    got = large_frame_study.run(256, 2, [9, 10], reps=1, device="cpu")
    want = _example("large_frame_study").run(256, 2, [9, 10], reps=1)
    assert sorted(got) == sorted(want)
    for cl in (9, 10):
        assert got[f"cl{cl}_file_bytes"] == want[f"cl{cl}_file_bytes"]
        assert got[f"cl{cl}_bpp"] == want[f"cl{cl}_bpp"]


@pytest.mark.parametrize("mod", [temporal_study, class_tables_study,
                                 ctx_study, large_frame_study])
def test_study_needs_a_card_unless_asked_for_the_cpu(mod, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((SystemExit, RuntimeError)):
        mod.main(["--fast"])
    capsys.readouterr()
    if mod is not large_frame_study:
        mod.main(["--fast", "--size", "2", "32", "--device", "cpu"])
        assert "plasma12s" in capsys.readouterr().out

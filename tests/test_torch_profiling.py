"""fpv_tpu_torch.utils.profiling: stage timers, traces and annotations."""

import json
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from fpv_tpu_torch.utils import profiling


def test_stage_timers_accumulate_and_reset():
    t = profiling.StageTimers()
    for _ in range(3):
        with t.stage("split"):
            time.sleep(0.002)
    with pytest.raises(KeyError):
        with t.stage("entropy"):
            raise KeyError("raised inside a stage")
    rep = t.report()
    assert list(rep) == ["entropy", "split"]
    assert rep["split"]["calls"] == 3 and rep["entropy"]["calls"] == 1
    assert rep["split"]["total_s"] >= 0.006
    assert rep["split"]["mean_ms"] == pytest.approx(
        1000 * rep["split"]["total_s"] / 3, abs=1e-3)
    t.reset()
    assert t.report() == {}


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

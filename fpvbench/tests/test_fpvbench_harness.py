"""The harness: cells and metrics found by name, the trace arithmetic, the
frozen byte counts, the import rule, and the check failing on every fault
planted under the timed path (on the CPU at a small size) and passing
without one."""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

import pytest

from fpvbench import bytecount, faults, harness, imports, trace as tracing

BENCH = harness.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
PER_LAYER = sorted({m["name"] for m in BENCH["per_layer"]} | {
    p.stem for p in (harness.ROOT / "metrics").glob("*.py")})
TRAFFIC = sorted(p.stem for p in (harness.ROOT / "traffic").glob("*.json"))
MODULES = sorted(p for p in harness.ROOT.rglob("*.py"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = harness.find(BENCH["workloads"], cell, "workload")
    cfg = harness.load_config(BENCH, c["config"])
    for key in ("width", "height", "bits", "shift", "big_endian",
                "frames_per_batch", "chunk_log2", "frames_per_recording",
                "content", "assumed", "reduced", "source"):
        assert key in cfg, key
    mix = harness.load_traffic(c["traffic"])
    mod = harness.entry_module(mix["entry"])
    assert callable(mod.Entry) and mod.SPAN and isinstance(mod.KEYS, dict)
    e2e = {m["name"] for m in harness.metrics_for(BENCH, "end_to_end", cell)}
    layer = harness.metrics_for(BENCH, "per_layer", cell)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("name", PER_LAYER)
def test_metric_reader_loads_by_name(name):
    read = harness.metric_reader(name)
    empty = harness.Reading(tracing.Trace((0.0, 1.0), [], []), {})
    assert read(empty) is None  # nothing to read: no value, never 0


@pytest.mark.parametrize("name", TRAFFIC)
def test_traffic_key_that_nothing_reads_is_refused(name, tmp_path,
                                                   monkeypatch):
    mix = harness.load_traffic(name)
    (tmp_path / "traffic").mkdir()
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    (tmp_path / "entries").symlink_to(harness.REPO / "fpvbench" / "entries")
    for bad in ({"clients": 4}, {"recordings": "2"},
                {"entry": "no_such_entry"}):
        (tmp_path / "traffic" / f"{name}.json").write_text(
            json.dumps(dict(mix, **bad)))
        with pytest.raises((ValueError, KeyError)):
            harness.load_traffic(name)
    (tmp_path / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    assert harness.load_traffic(name) == mix


def _iv(name, a, b, kind="kernel"):
    return tracing.Interval(name, a, b, kind)


def test_idle_share_of_overlapping_kernels_and_copies():
    device = [
        _iv("k_a", 1.0, 3.0), _iv("k_b", 2.0, 4.0),  # two streams overlap
        _iv("Memcpy HtoD", 3.5, 5.0, "memcpy"),
        _iv("k_c", 6.0, 7.0), _iv("Memset", 6.5, 6.8, "memset"),
        _iv("k_early", -2.0, 0.5),  # clipped to the window
        _iv("k_late", 9.5, 12.0),
    ]
    tr = tracing.Trace((0.0, 10.0), device, [])
    assert tr.busy_s() == pytest.approx(0.5 + 4.0 + 1.0 + 0.5)
    assert tr.idle_gaps() == [(0.5, 1.0), (5.0, 6.0), (7.0, 9.5)]
    read = harness.metric_reader("device_idle_pct.decode")
    got = read(harness.Reading(tr, {}))
    assert got == pytest.approx(100 * (1 - 6.0 / 10.0))
    per_batch = harness.metric_reader("device_ms_per_batch.decode")
    assert per_batch(harness.Reading(tr, {"batches": 3})) == pytest.approx(
        1e3 * 6.0 / 3)
    assert [k.name for k in tr.kernels(("k_",))] == ["k_a", "k_b", "k_c"]


def test_breakdown_labels_idle_time_by_host_span():
    host = [tracing.Interval("window", 0.0, 10.0, "cpu", 7),
            tracing.Interval("pass", 0.0, 6.0, "cpu", 7),
            tracing.Interval("aten::copy_", 0.2, 0.9, "cpu", 7),
            tracing.Interval("pass", 6.0, 10.0, "cpu", 7)]
    device = [_iv("k", 1.0, 2.0), _iv("k", 5.0, 7.0)]
    bd = tracing.breakdown(tracing.Trace((0.0, 10.0), device, host,
                                         ("window", "pass")))
    assert bd["device_ops"] == [["k", 3.0]]
    assert dict((k, pytest.approx(v)) for k, v in bd["idle_gaps"]) == {
        "pass / aten::copy_": 1.0, "pass / python": 6.0}


def _main_batch(high_words, low_words, pv_words):
    hi = dict(coding=0, nblocks=8, chunk_len=4096, lanes=1024, nseg=8,
              words=high_words)
    lo = dict(hi, coding=1, words=low_words)
    pv = dict(coding=0, nblocks=4, chunk_len=512, lanes=1024, nseg=1,
              words=pv_words)
    return hi, lo, pv


def test_frozen_byte_counts_of_a_main_batch():
    # the main corpus' first batch as the kernel table measured it: K1
    # coded 10,998,640 payload words over the three planes, K2 decoded
    # 10,809,977 of the two main planes
    hi, lo, pv = _main_batch(0, 0, 0)
    fixed1 = sum(bytecount.k1_bytes(s) for s in (hi, lo, pv))
    assert fixed1 == 69_374_480  # K1a's share, no payload in it
    hi, lo, pv = _main_batch(10_809_977 - 8_000_000, 8_000_000,
                             10_998_640 - 10_809_977)
    assert sum(bytecount.k1_bytes(s) for s in (hi, lo, pv)) == 91_371_760
    assert sum(bytecount.k2_bytes(s) for s in (hi, lo)) == 88_959_730
    share = bytecount.roofline_pct(88_959_730, 3.147e-3)
    assert share == pytest.approx(0.84, abs=0.005)  # PR 3's K2 row
    assert bytecount.roofline_pct(1.0, 0.0) is None


def _imported_tops(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and (
                not node.level):
            names.add(node.module)
    return {n.split(".", 1)[0] for n in names}


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(harness.ROOT)) for p in MODULES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imports.forbidden(_imported_tops(path))


def test_import_rule_compares_top_level_names_whole():
    assert imports.forbidden(["fpv_tpu_torch.api", "jaxtyping", "numpy"]) == []
    assert imports.forbidden(["fpv_tpu.ops", "jax.numpy", "x"]) == [
        "fpv_tpu", "jax"]


def test_a_run_loads_no_jax():
    """Every module of the harness and the program it drives, imported in
    a fresh process: nothing forbidden in sys.modules."""
    mods = ["fpvbench." + ".".join(p.relative_to(harness.ROOT).with_suffix(
        "").parts) for p in MODULES
        if "tests" not in p.parts and "metrics" not in p.parts]
    code = ("import sys, fpv_tpu_torch\n"
            + "".join(f"import {m}\n" for m in mods)
            + "from fpvbench import harness, imports\n"
            + "for m in harness.load_benchmark()['per_layer']:\n"
            + "    harness.metric_reader(m['name'])\n"
            + "print(imports.forbidden(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _small(config):
    """The configuration at a size the CPU runs in seconds."""
    cfg = harness.load_config(BENCH, config)
    return dict(cfg, width=64, height=32, frames_per_batch=4, chunk_log2=6,
                frames_per_recording=9)


# every configuration under every traffic mix, the cells of BENCHMARK.json
# among them: a mix kept for a later cell stays tested
COMBOS = [(c["name"], t) for c in BENCH["configs"] for t in TRAFFIC]


@pytest.mark.parametrize("fault", (None,) + faults.FAULTS)
@pytest.mark.parametrize("config,traffic", COMBOS,
                         ids=[f"{c}.{t}" for c, t in COMBOS])
def test_check_fails_on_every_planted_fault(config, traffic, fault):
    name = f"{config}.{traffic}"
    cells = [w for w in BENCH["workloads"] if w["name"] != name]
    bench = dict(BENCH, workloads=cells + [dict(
        name=name, config=config, traffic=traffic, chips=1, why="test")])
    res = harness.run_cell(name, 2**31 + 11, 0.3, False, "cpu", fault,
                           bench=bench, cfg=_small(config))
    assert res["correct"] == (fault is None), res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    e2e = {m["name"] for m in harness.metrics_for(BENCH, "end_to_end", name)}
    assert set(res["metrics"]) == e2e


def test_traced_run_reports_its_window():
    res = harness.run_cell("cam12_1mp.seek", 5, 0.3, True, "cpu",
                           cfg=_small("cam12_1mp"))
    assert res["correct"]
    assert res["device"]["window_s"] > 0
    assert res["metrics"] == {}  # no device: every per-layer reader is silent
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the run without a card")


def test_run_without_a_card_prints_no_result(no_card):
    out = subprocess.run(
        [sys.executable, "-m", "fpvbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the cells run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card_and_its_control(card, cell):
    """The cell at its own size for a short window: correct, and not
    correct with the control (one bit of precision dropped)."""
    for fault, want in ((None, True), ("lossy", False)):
        out = subprocess.run(
            [sys.executable, "-m", "fpvbench.run", "--workload", cell,
             "--seed", "4242", "--seconds", "2", "--trace", "0"]
            + (["--fault", fault] if fault else []),
            cwd=harness.REPO, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-4000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"] is want, res["checks"]

"""The readers of the program's spans (fpvbench/spans.py): the card's idle
time charged by exact intersection to the innermost ``fpvt.*`` span on
the window's thread, on hand-built traces and on a traced run of each
cell on the CPU."""

from __future__ import annotations

import pytest

from fpvbench import harness, spans, trace as tracing

BENCH = harness.load_benchmark()
DECODE = ["idle_ms_per_batch." + s for s in (
    "open", "parse", "stage", "dispatch", "finalize", "assemble")]
SEEK = ["idle_ms_per_request." + s for s in ("parse", "chain", "download")]
OUTSIDE = {"pass": "idle_outside_spans_pct.decode",
           "request": "idle_outside_spans_pct.seek"}


def _h(name, a, b, thread=7):
    return tracing.Interval(name, a, b, "cpu", thread)


def _k(a, b):
    return tracing.Interval("k", a, b, "kernel")


def _replay_trace(program=True):
    """Two ``pass`` calls (0-6, 6.5-10); ``open`` holds a nested
    ``parse``; the idle gap 1.3-3 straddles ``parse``, ``open`` and
    ``stage``; 5-6 and 9-10 lie under no program span; 6-6.5 under no
    call; a span of another thread is not the window's."""
    host = [_h("window", 0, 10), _h("pass", 0, 6), _h("pass", 6.5, 10)]
    if program:
        host += [_h("fpvt.read.open", 0.5, 2), _h("fpvt.read.parse", 1, 1.5),
                 _h("fpvt.read.stage", 2, 4),
                 _h("fpvt.read.finalize", 7, 9),
                 _h("fpvt.read.assemble", 5, 7, thread=8)]
    device = [_k(1.2, 1.3), _k(3, 5), _k(8, 8.5)]
    return tracing.Trace((0.0, 10.0), device, host, ("window", "pass"))


def test_idle_is_charged_to_the_innermost_span_by_exact_intersection():
    idle = spans.idle_by_span(_replay_trace(), "pass")
    want = {"fpvt.read.open": 1.0, "fpvt.read.parse": 0.4,
            "fpvt.read.stage": 1.0, "fpvt.read.finalize": 1.5,
            spans.OUTSIDE: 3.0}
    assert idle.keys() == want.keys()
    for k, v in want.items():
        assert idle[k] == pytest.approx(v), k
    # the idle time under the calls, and nothing else, is shared out
    assert sum(idle.values()) == pytest.approx(1.2 + 1.7 + 1.0 + 1.5 + 1.5)


def test_replay_readers_add_up_to_the_idle_time_under_the_calls():
    tr = _replay_trace()
    reading = harness.Reading(tr, {"batches": 2})
    got = {m: harness.metric_reader(m)(reading) for m in DECODE}
    assert got == pytest.approx({
        "idle_ms_per_batch.open": 500.0, "idle_ms_per_batch.parse": 200.0,
        "idle_ms_per_batch.stage": 500.0, "idle_ms_per_batch.dispatch": 0.0,
        "idle_ms_per_batch.finalize": 750.0,
        "idle_ms_per_batch.assemble": 0.0})
    outside = harness.metric_reader(OUTSIDE["pass"])(reading)
    assert outside == pytest.approx(100 * 3.0 / 6.9)
    total = 6.9
    assert sum(v * 2 / 1e3 for v in got.values()) + (
        outside / 100 * total) == pytest.approx(total)


def test_readers_are_silent_without_program_spans_or_device():
    """A program without spans (the parent of the change that added them)
    and a run without a card: every reader returns None, never 0."""
    bare = harness.Reading(_replay_trace(program=False),
                           {"batches": 2, "requests": 2})
    no_card = harness.Reading(
        tracing.Trace((0.0, 10.0), [], _replay_trace().host),
        {"batches": 2, "requests": 2})
    names = DECODE + SEEK + list(OUTSIDE.values()) + [
        "sections_parsed_per_request.seek"]
    for name in names:
        read = harness.metric_reader(name)
        assert read(bare) is None, name
        assert read(no_card) is None, name


def test_seek_readers_count_sections_and_charge_chain_frames():
    host = [_h("window", 0, 10), _h("request", 1, 4), _h("request", 5, 9)]
    # request 1: parse, two chain frames, the download
    host += [_h("fpvt.read.parse", 1, 2), _h("fpvt.read.chain", 2, 2.5),
             _h("fpvt.read.chain", 2.5, 3.5), _h("fpvt.read.download",
                                                 3.5, 4)]
    # request 2: parse, one chain frame; 8-9 covered by no span
    host += [_h("fpvt.read.parse", 5, 6), _h("fpvt.read.chain", 6, 8)]
    device = [_k(2.2, 2.5), _k(3.0, 3.6), _k(6.5, 7.5)]
    tr = tracing.Trace((0.0, 10.0), device, host, ("window", "request"))
    reading = harness.Reading(tr, {"requests": 2})
    read = {m: harness.metric_reader(m)(reading) for m in SEEK + [
        OUTSIDE["request"], "sections_parsed_per_request.seek"]}
    # idle under requests: 1-2.2, 2.5-3.0, 3.6-4, 5-6.5, 7.5-9 = 5.1 s
    assert read["idle_ms_per_request.parse"] == pytest.approx(1e3 * 2.0 / 2)
    assert read["idle_ms_per_request.chain"] == pytest.approx(
        1e3 * (0.2 + 0.5 + 0.5 + 0.5) / 2)
    assert read["idle_outside_spans_pct.seek"] == pytest.approx(
        100 * 1.0 / 5.1)
    assert read["idle_ms_per_request.download"] == pytest.approx(
        1e3 * 0.4 / 2)
    assert read["sections_parsed_per_request.seek"] == 1.0
    # the parts and the outside share add up to the idle time under the
    # requests
    parts = sum(read[m] for m in SEEK) * 2 / 1e3
    assert parts + read["idle_outside_spans_pct.seek"] / 100 * 5.1 == (
        pytest.approx(5.1))


def _small(config):
    cfg = harness.load_config(BENCH, config)
    return dict(cfg, width=64, height=32, frames_per_batch=4, chunk_log2=6,
                frames_per_recording=9)


@pytest.mark.parametrize("cell,call,names", [
    ("cam16_1mp.replay", "pass", DECODE),
    ("cam12_1mp.seek", "request", SEEK),
])
def test_traced_run_carries_the_program_spans(cell, call, names,
                                              monkeypatch):
    """A traced run of the cell on the CPU: its trace holds the program's
    spans on the window's thread, each inside a call; with no card the
    readers are silent, and with device work placed in the trace they
    report, their parts adding up to the idle time under the calls."""
    readings = []
    real = harness.metric_reader

    def capture(name):
        read = real(name)

        def wrapped(reading):
            readings.append(reading)
            return read(reading)
        return wrapped

    monkeypatch.setattr(harness, "metric_reader", capture)
    c = harness.find(BENCH["workloads"], cell, "workload")
    res = harness.run_cell(cell, 2**31 + 5, 0.3, True, "cpu",
                           cfg=_small(c["config"]))
    assert res["correct"] and res["metrics"] == {}
    reading = readings[0]
    tr = reading.trace
    prog = spans.program_spans(tr)
    calls = [h for h in tr.host if h.name == call]
    assert prog and calls
    assert all(any(c.start <= h.start and h.end <= c.end for c in calls)
               for h in prog)
    got = {h.name for h in prog}
    if call == "pass":
        assert got == {"fpvt.read." + s for s in (
            "open", "parse", "stage", "dispatch", "finalize", "assemble")}
    else:  # the small file is narrow: a miss decodes the frame's batch
        assert {"fpvt.read.parse", "fpvt.read.download"} & got
    # device work in the middle of every program span
    device = [_k((h.start + h.end) / 2, (h.start + h.end) / 2 + 1e-7)
              for h in prog]
    traced = harness.Reading(
        tracing.Trace(tr.window, device, tr.host, tr.spans), reading.counts)
    per = "batches" if call == "pass" else "requests"
    n = reading.counts[per]
    idle = spans.idle_by_span(traced.trace, call)
    total = sum(idle.values())
    for m in names:
        stage = "fpvt.read." + m.rsplit(".", 1)[1]
        assert harness.metric_reader(m)(traced) == pytest.approx(
            1e3 * idle.get(stage, 0.0) / n), m
    outside = harness.metric_reader(OUTSIDE[call])(traced)
    assert outside == pytest.approx(100 * idle.get(spans.OUTSIDE, 0) / total)
    if call == "pass":  # every span of a whole-file decode has its metric
        parts = sum(harness.metric_reader(m)(traced) for m in names)
        assert parts * n / 1e3 + outside / 100 * total == pytest.approx(
            total)
    else:
        sections = harness.metric_reader("sections_parsed_per_request.seek")
        assert sections(traced) == pytest.approx(
            spans.count(tr, "fpvt.read.parse") / n)

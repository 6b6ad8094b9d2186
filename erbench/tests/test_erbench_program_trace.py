"""The reduction of the program's spans against the card's idle time
(``erbench.program_trace``) on synthetic windows, the clock the program's
spans share with ``torch.profiler``, each new metric reader on a fixed
record, and the new metrics in traced CPU runs of small cells."""
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from erbench import program_trace as pt
from erbench.trace import SHORT_GAPS, Trace, reduce_trace
from erbench.tests.helpers import run_small
from repro_torch.er import trace

METRICS = Path(__file__).resolve().parent.parent / "metrics"
MS = 1_000_000                  # ns


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(name, thread, start, end, parent=None):
    return {"id": id((name, thread, start)), "parent": parent, "name": name,
            "thread": thread, "start_ns": start * MS, "end_ns": end * MS,
            "attrs": {}}


def _dev(*ms):
    return [(a * MS, b * MS) for a, b in ms]


def test_idle_goes_to_the_executor_not_to_the_latest_started_span():
    """The planner's lower starts after the executor's stage 2: the
    harness's rule gives the gap to the lower, this one to stage 2."""
    spans = [_span("service.execute_batch", "exec", 0, 100),
             _span("stage2.verify", "exec", 1, 99),
             _span("service.plan_batch", "plan", 10, 90),
             _span("compiler.lower", "plan", 20, 80)]
    dev = _dev((0, 5), (95, 100))
    out = pt.reduce_program(spans, dev, 0, 100 * MS)
    assert out["executor"] == "exec" and out["planner"] == "plan"
    assert out["idle"] == {"stage2.verify": pytest.approx(0.090)}
    assert out["unattributed_s"] == 0.0
    assert out["idle_s"] == pytest.approx(0.090)
    harness = reduce_trace([(a, b, "k") for a, b in dev],
                           [(s["start_ns"], s["end_ns"], s["name"])
                            for s in spans], 0, 100 * MS)
    assert dict(harness["breakdown"]["idle_gaps"])["compiler.lower"] == \
        pytest.approx(0.060)


def test_a_starved_executor_puts_idle_on_the_planner():
    spans = [_span("batcher.await_plan", "exec", 0, 50),
             _span("service.execute_batch", "exec", 50, 100),
             _span("stage1.score", "exec", 55, 70),
             _span("service.plan_batch", "plan", 0, 40),
             _span("compiler.lower", "plan", 10, 30)]
    out = pt.reduce_program(spans, _dev((60, 65)), 0, 100 * MS)
    assert out["idle"] == pytest.approx({
        "service.plan_batch (starved)": 0.020,
        "compiler.lower (starved)": 0.020,
        "batcher.await_plan (starved)": 0.010,
        "stage1.score": 0.010,
        "service.execute_batch": 0.035})
    assert out["idle_s"] == pytest.approx(0.095)
    rec = {"kind": "service", "trace": {"program": out}}
    assert _reader("device.idle_starved_pct.service")(rec) == \
        pytest.approx(50.0)
    assert _reader("device.idle_stage2_pct.service")(rec) == 0.0


def test_gaps_under_100_us_are_attributed_too():
    """Stage 2's launches leave 10 us gaps: all of them go to stage 2,
    where the harness sums them apart."""
    us = 1000
    spans = [{"id": 1, "parent": None, "name": "stage2.verify",
              "thread": "MainThread", "start_ns": 0, "end_ns": 1000 * us,
              "attrs": {}}]
    dev = [(k * 20 * us, k * 20 * us + 10 * us) for k in range(50)]
    out = pt.reduce_program(spans, dev, 0, 1000 * us)
    assert out["idle"] == {"stage2.verify": pytest.approx(500e-6)}
    harness = reduce_trace([(a, b, "k") for a, b in dev],
                           [(0, 1000 * us, "stage2.verify")], 0, 1000 * us)
    assert dict(harness["breakdown"]["idle_gaps"])[SHORT_GAPS] == \
        pytest.approx(500e-6)


def test_idle_outside_every_executor_span_is_unattributed():
    spans = [_span("pipeline.run_er", "MainThread", 10, 60),
             _span("stage1.score", "MainThread", 20, 30)]
    out = pt.reduce_program(spans, _dev((25, 30)), 0, 100 * MS)
    assert out["executor"] == "MainThread" and out["planner"] is None
    assert out["unattributed_s"] == pytest.approx(0.050)
    assert out["idle"][pt.NO_SPAN] == pytest.approx(0.050)
    assert out["idle"]["stage1.score"] == pytest.approx(0.005)
    assert out["idle"]["pipeline.run_er"] == pytest.approx(0.040)
    assert out["spans"] == {"stage1.score": [1, pytest.approx(0.010)],
                            "pipeline.run_er": [1, pytest.approx(0.050)]}


def test_spans_count_only_where_they_end_inside_the_window():
    spans = [_span("service.plan_batch", "plan", -30, 10),
             _span("service.plan_batch", "plan", 20, 40),
             _span("service.plan_batch", "plan", 90, 130),
             _span("stage1.score", "exec", 0, 5)]
    out = pt.reduce_program(spans, [], 0, 100 * MS)
    assert out["spans"]["service.plan_batch"] == [2, pytest.approx(0.060)]


FIXED = {"window_s": 10.0, "idle_s": 9.0, "unattributed_s": 0.1,
         "executor": "erbatcher-exec", "planner": "erbatcher-plan",
         "idle": {"stage2.verify": 5.0, "stage1.score": 1.0,
                  "compiler.lower (starved)": 1.5,
                  "batcher.await_plan (starved)": 0.5, pt.NO_SPAN: 0.1},
         "spans": {"batcher.queue": [40, 8.0],
                   "service.plan_batch": [20, 3.0],
                   "service.execute_batch": [20, 5.0],
                   "pipeline.run_er": [4, 28.0],
                   "compiler.plan_job": [4, 10.0],
                   "compiler.lower": [8, 12.0]}}


@pytest.mark.parametrize("name, kind, want", [
    ("batcher.queue_ms", "service", 200.0),
    ("service.plan_ms", "service", 150.0),
    ("service.execute_ms", "service", 250.0),
    ("device.idle_stage2_pct.service", "service", 50.0),
    ("device.idle_starved_pct.service", "service", 20.0),
    ("compiler.plan_job_s", "batch", 2.5),
    ("compiler.lower_s", "batch", 3.0),
])
def test_each_new_reader_on_a_fixed_record(name, kind, want):
    read = _reader(name)
    rec = {"kind": kind, "trace": {"program": FIXED}}
    assert read(rec) == pytest.approx(want)
    other = "batch" if kind == "service" else "service"
    assert read({"kind": other, "trace": {"program": FIXED}}) is None
    assert read({"kind": kind, "trace": None}) is None
    assert read({"kind": kind, "trace": {"program": None}}) is None
    assert read({"kind": kind}) is None


@pytest.mark.parametrize("name", [
    "batcher.queue_ms", "service.plan_ms", "service.execute_ms",
    "device.idle_stage2_pct.service", "device.idle_starved_pct.service",
    "compiler.plan_job_s", "compiler.lower_s"])
def test_a_window_with_dropped_spans_reads_nothing(name):
    kind = "batch" if name.startswith("compiler.") else "service"
    prog = dict(FIXED, dropped=0)
    assert _reader(name)({"kind": kind, "trace": {"program": prog}}) \
        is not None
    prog = dict(FIXED, dropped=1)
    rec = {"kind": kind, "trace": {"program": prog}}
    assert _reader(name)(rec) is None
    assert rec["trace"]["program"]["dropped"] == 1     # kept, for a reader


def test_a_program_without_the_tracer_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.er.trace", None)
    assert pt._from_window(object()) is None
    # no traced window among the callers: nothing either
    rec = {"kind": "service", "trace": {"busy_s": 1.0}}
    assert pt.program(rec) is None and rec["trace"]["program"] is None


def test_program_spans_and_the_profiler_share_one_clock():
    """Under a CPU profile, a program span around ``torch.mm`` encloses
    the profiler's ``aten::mm`` event as the spans stand."""
    torch.set_num_threads(1)
    a = torch.randn(384, 384)
    tracer = Trace(True)
    with tracer.window():
        for _ in range(3):
            with trace.span("outer"):
                torch.mm(a, a)
    spans = [s for s in trace.collect() if s["name"] == "outer"][-3:]
    mms = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in tracer.prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(spans) == len(mms) == 3
    for s, (m0, m1) in zip(spans, mms):
        assert s["start_ns"] <= m0 < m1 <= s["end_ns"]
    # the harness's shift is the window mark's latency, not a clock offset
    prog = pt._from_window(tracer)
    assert abs(prog["harness_shift_ns"]) < 50 * MS


@pytest.mark.parametrize("cell, names", [
    ("ds1_products.batch_pair_range",
     ("compiler.plan_job_s", "compiler.lower_s")),
    ("ds1_products.service_closed32",
     ("batcher.queue_ms", "service.plan_ms", "service.execute_ms",
      "device.idle_stage2_pct.service", "device.idle_starved_pct.service")),
])
def test_traced_runs_report_the_new_metrics(cell, names):
    out = run_small(cell, trace=True, seconds=1.0)
    assert out["correct"]
    for name in names:
        assert out["metrics"][name]["value"] >= 0.0, name
    assert "idle_gaps" in out["breakdown"]

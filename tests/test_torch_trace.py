"""The port's tracer (``repro_torch.er.trace``): nesting and parent ids,
thread names, explicit parents across threads, the bounded buffer's drop
count, nothing recorded while off (yet a duration), recording while
``torch.profiler`` runs; and the spans of ``run_er``, ``ERService`` and
``ERBatcher`` on small corpora on the CPU: the span tree, one
``batcher.queue`` span a request tied to its super-batch's plan and
execute spans, and the timers that are views of the spans."""
import threading
import time

import pytest
import torch

from repro_torch.er import (ERBatcher, ERConfig, ERService, ServiceConfig,
                            make_products, run_er, trace)


@pytest.fixture(autouse=True)
def _tracer_off():
    torch.set_num_threads(1)
    trace.enable()              # an empty buffer,
    trace.disable()             # and off
    yield
    trace.disable()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def _secs(s):
    return (s["end_ns"] - s["start_ns"]) * 1e-9


def test_spans_nest_take_parent_ids_and_inherit_request_ids():
    trace.enable()
    with trace.span("outer", super_batch=7) as outer:
        with trace.span("inner", request=3) as inner:
            pass
        with trace.span("second"):
            pass
    spans = _by_name(trace.collect())
    o, i, s = spans["outer"][0], spans["inner"][0], spans["second"][0]
    assert o["parent"] is None and i["parent"] == o["id"] == s["parent"]
    assert len({o["id"], i["id"], s["id"]}) == 3
    assert i["attrs"] == {"request": 3, "super_batch": 7}
    assert s["attrs"] == {"super_batch": 7}
    assert o["start_ns"] <= i["start_ns"] <= i["end_ns"] <= s["start_ns"] \
        <= s["end_ns"] <= o["end_ns"]
    assert inner.seconds == _secs(i) and outer.seconds == _secs(o)
    assert {x["thread"] for x in (o, i, s)} == {"MainThread"}
    assert [x["name"] for x in trace.collect()] == ["inner", "second",
                                                    "outer"]


def test_thread_names_and_explicit_parents_across_threads():
    trace.enable()
    with trace.span("request") as req:
        queued = trace.start("queue", request=5)

    def worker():
        with trace.span("work", parent=req) as w:
            with trace.span("child"):
                pass
        queued.finish(super_batch=w.id)

    th = threading.Thread(target=worker, name="worker-1")
    th.start()
    th.join(10)
    assert not th.is_alive()
    spans = _by_name(trace.collect())
    work, child = spans["work"][0], spans["child"][0]
    q, r = spans["queue"][0], spans["request"][0]
    assert work["thread"] == child["thread"] == "worker-1"
    assert work["parent"] == r["id"] and child["parent"] == work["id"]
    # started on the main thread, ended on the worker, on no stack
    assert q["thread"] == "MainThread" and q["parent"] == r["id"]
    assert q["attrs"] == {"request": 5, "super_batch": work["id"]}
    assert q["end_ns"] >= work["end_ns"]


def test_the_buffer_is_bounded_and_counts_what_it_drops():
    trace.enable(capacity=3)
    for k in range(5):
        with trace.span("s", k=k):
            pass
    assert [s["attrs"]["k"] for s in trace.collect()] == [0, 1, 2]
    assert trace.dropped() == 2
    trace.enable()
    assert trace.collect() == [] and trace.dropped() == 0


def test_off_a_span_records_nothing_yet_gives_its_duration():
    assert not trace.recording()
    with trace.span("x", request=1) as sp:
        time.sleep(0.002)
    assert sp.seconds >= 0.002 and sp.id is None
    trace.start("q").finish(super_batch=1)
    assert trace.collect() == [] and trace.dropped() == 0


def test_a_profiler_session_turns_recording_on():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert trace.recording()
        with trace.span("profiled"):
            pass
    assert not trace.recording()
    assert [s["name"] for s in trace.collect()] == ["profiled"]


# ---------------------------------------------------------------------------
# The program's spans
# ---------------------------------------------------------------------------

DS = make_products(400, seed=1)
CFG = dict(feature_dim=128, max_len=48)


def test_run_er_span_tree_and_timings_are_views_of_it():
    trace.enable()
    titles = list(DS.titles) + ["", "  "]
    res = run_er(titles, ERConfig(**CFG), device="cpu")
    spans = trace.collect()
    by_id = {s["id"]: s for s in spans}
    names = _by_name(spans)
    run = names["pipeline.run_er"][0]
    assert run["parent"] is None and run["attrs"] == {}

    def children(s):
        return sorted(x["name"] for x in spans if x["parent"] == s["id"])

    assert children(run) == sorted([
        "encode.featurize", "compiler.plan_job", "compiler.lower",
        "compiler.schedule", "pipeline.upload", "stage1.score",
        "stage2.verify", "pipeline.collect", "pipeline.cross"])
    assert children(names["compiler.plan_job"][0]) == ["compiler.job1"]
    cross = names["pipeline.cross"][0]
    assert children(cross) == ["compiler.lower", "pipeline.collect",
                               "stage1.score", "stage2.verify"]
    assert all(by_id[s["parent"]]["name"] in ("pipeline.run_er",
                                              "pipeline.cross",
                                              "compiler.plan_job",
                                              "stage1.score")
               for s in spans if s["parent"] is not None)
    # the survivors are decoded inside stage 1, once a job here
    assert [by_id[s["parent"]]["name"] for s in names["stage1.decode"]] \
        == ["stage1.score"] * 2
    main = [s for s in names["stage1.score"] if s["parent"] == run["id"]][0]
    verify = [s for s in names["stage2.verify"]
              if s["parent"] == run["id"]][0]
    assert all(s["attrs"] == {} for s in spans)        # no counts, no ids
    tm = res.extra["timings"]
    one = {k: _secs(names[n][0]) for k, n in (
        ("featurize_s", "encode.featurize"), ("upload_s", "pipeline.upload"),
        ("cross_s", "pipeline.cross"), ("total_s", "pipeline.run_er"),
        ("job1_s", "compiler.job1"))}
    assert {k: tm[k] for k in one} == one
    assert tm["stage1_s"] == _secs(main) and tm["stage2_s"] == _secs(verify)
    main_lower = [s for s in names["compiler.lower"]
                  if s["parent"] == run["id"]][0]
    assert tm["plan_s"] == pytest.approx(
        _secs(names["compiler.plan_job"][0]) - tm["job1_s"]
        + _secs(main_lower) + _secs(names["compiler.schedule"][0]),
        abs=1e-9)
    assert "decode_s" not in tm


def test_sorted_neighborhood_job1_is_the_sort():
    trace.enable()
    res = run_er(DS.titles, ERConfig(strategy="sorted_neighborhood", **CFG),
                 device="cpu")
    names = _by_name(trace.collect())
    assert res.bdm_seconds == _secs(names["compiler.job1"][0])
    assert "pipeline.cross" not in names


def test_stage1_stats_carries_counts_only():
    from repro_torch.er import stage1_stats
    assert "kernel_seconds" not in stage1_stats
    assert "decode_seconds" not in stage1_stats
    assert {"compact_decodes", "nonzero_decodes", "compact_overflows",
            "interconnect"} <= set(stage1_stats)


def _service():
    corpus = list(DS.titles[:300]) + [""]
    svc = ERService(corpus, ServiceConfig(
        r=8, m=4, query_buckets=(8, 32), tile_chunk=64, **CFG), device="cpu")
    svc.warmup()
    return svc


def _requests():
    qs = list(DS.titles[300:390])
    reqs = [qs[k:k + 5] for k in range(0, len(qs), 5)]
    reqs[3] = reqs[3] + ["", "@@@ never seen"]
    return reqs


def test_batcher_spans_tie_each_request_to_its_super_batch():
    svc = _service()
    with ERBatcher(svc, max_batch=32) as batcher:
        seconds0, batches0 = svc.stats["seconds"], svc.stats["batches"]
        trace.enable()
        futs = [batcher.submit(r) for r in _requests()]
        for f in futs:
            f.result(timeout=60)
    trace.disable()
    spans = trace.collect()
    names = _by_name(spans)
    queue = names["batcher.queue"]
    plans = {s["attrs"]["super_batch"]: s for s in names["service.plan_batch"]}
    execs = {s["attrs"]["super_batch"]: s
             for s in names["service.execute_batch"]}
    assert len(plans) == len(names["service.plan_batch"])
    assert len(execs) == len(names["service.execute_batch"])
    assert sorted(s["attrs"]["request"] for s in queue) == \
        list(range(1, len(futs) + 1))
    for q in queue:
        assert q["attrs"]["super_batch"] in plans
        assert q["attrs"]["super_batch"] in execs
    assert set(plans) == set(execs) == {q["attrs"]["super_batch"]
                                        for q in queue}
    assert {p["thread"] for p in plans.values()} == {"erbatcher-plan"}
    assert {e["thread"] for e in execs.values()} == {"erbatcher-exec"}
    assert {s["thread"] for s in names["batcher.handoff"]} == \
        {"erbatcher-plan"}
    assert {s["thread"] for s in names["batcher.await_plan"]} == \
        {s["thread"] for s in names["batcher.demux"]} == {"erbatcher-exec"}
    assert {s["attrs"]["super_batch"] for s in names["batcher.demux"]} == \
        set(execs)
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"] in ("encode.featurize", "compiler.plan",
                         "compiler.lower"):
            assert by_id[s["parent"]]["name"] == "service.plan_batch"
        if s["name"] in ("stage1.score", "stage2.verify", "service.demap"):
            assert by_id[s["parent"]]["name"] == "service.execute_batch"
        if s["parent"] is not None:
            assert s["attrs"]["super_batch"] == \
                by_id[s["parent"]]["attrs"]["super_batch"]
    assert len(names["compiler.plan"]) == len(plans)
    assert len(names["stage1.score"]) == len(names["stage2.verify"]) == \
        len(names["service.demap"])
    assert svc.stats["batches"] - batches0 == len(execs)
    assert svc.stats["seconds"] - seconds0 == pytest.approx(sum(
        (e["end_ns"] - plans[k]["start_ns"]) * 1e-9
        for k, e in execs.items()), abs=1e-9)


def test_match_without_batcher_spans_one_request():
    svc = _service()
    seconds0 = svc.stats["seconds"]
    trace.enable()
    resp = svc.match(_requests()[3])
    names = _by_name(trace.collect())
    plan, = names["service.plan_batch"]
    ex, = names["service.execute_batch"]
    assert plan["attrs"]["super_batch"] == ex["attrs"]["super_batch"]
    assert len(resp) > 0
    assert len(names["stage1.score"]) == 3 == len(names["stage2.verify"])
    assert svc.stats["seconds"] - seconds0 == pytest.approx(
        (ex["end_ns"] - plan["start_ns"]) * 1e-9, abs=1e-9)


def test_off_run_er_and_a_batcher_run_record_nothing():
    run_er(DS.titles, ERConfig(**CFG), device="cpu")
    svc = _service()
    with ERBatcher(svc, max_batch=32) as batcher:
        for f in [batcher.submit(r) for r in _requests()]:
            f.result(timeout=60)
    assert trace.collect() == [] and trace.dropped() == 0

"""Service traffic: closed-loop clients against ``ERBatcher`` over a
resident ``ERService``.

Set-up makes the corpus, ingests it (``ERService``), warms every shape
bucket (``ERService.warmup``), starts the batcher and serves one request
through it. In the window each client sends a request, waits for its
answer, and sends the next; a client sends no request after
``--seconds``, and the window closes when the last answer arrives.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import gc
import threading
import time

import numpy as np
import torch

from .. import check
from ..data import RequestStream, make_corpus
from ..reference.er import prefix_key

ANSWER_TIMEOUT_S = 120.0
SPANS = (("_plan_batch", "service.plan_batch"),
         ("_execute_batch", "service.execute_batch"))
MODULE_SPANS = (("featurize", "encode.featurize"),
                ("plan_pair_range_2src", "compiler.plan"),
                ("lower", "compiler.lower"), ("execute", "stage1.execute"),
                ("verify_pairs", "stage2.verify_pairs"))


def _program():
    from repro_torch.er import batcher, service
    return service, batcher


def survivor_modules():
    return [_program()[0]]


def span_targets():
    service, _ = _program()
    return ([(service.ERService, attr, name) for attr, name in SPANS]
            + [(service, attr, name) for attr, name in MODULE_SPANS])


class _RowCounter:
    """Rows each stage-1 job reads, counted from the plans the service
    makes: the corpus rows of every block a query falls in, the queries,
    and the whole of both sides of a match_⊥ job."""

    def __init__(self, service_mod):
        self.mod = service_mod
        self.rows = 0
        self.saved = []

    def __enter__(self):
        mod = self.mod
        plan, cross = mod.plan_pair_range_2src, mod.cross_job

        def counted_plan(bdm2, *a, **k):
            hit = bdm2.bdm_s.sum(axis=1) > 0
            self.rows += int(bdm2.bdm_r[hit].sum()) + int(bdm2.bdm_s.sum())
            return plan(bdm2, *a, **k)

        def counted_cross(n_a, n_b, *a, **k):
            self.rows += int(n_a) + int(n_b)
            return cross(n_a, n_b, *a, **k)

        self.saved = [("plan_pair_range_2src", plan), ("cross_job", cross)]
        mod.plan_pair_range_2src = counted_plan
        mod.cross_job = counted_cross
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved:
            setattr(self.mod, attr, fn)
        return False


def setup(cell):
    service_mod, batcher_mod = _program()
    corpus = make_corpus(cell.config["data"], cell.seed)
    svc = dict(cell.config["service"])
    if int(svc["prefix_len"]) != corpus.key_width:
        raise ValueError("prefix_len differs from the corpus's key width")
    t = cell.traffic
    streams = [RequestStream(corpus.titles, corpus.key_width, t, cell.seed,
                             c, int(t["requests_per_client"]))
               for c in range(int(t["clients"]))]
    service = service_mod.ERService(
        corpus.titles, service_mod.ServiceConfig(**svc), device=cell.device)
    service.warmup()
    batcher = batcher_mod.ERBatcher(service, max_delay_s=float(t["max_delay_s"]),
                                    max_batch=int(t["max_batch"]))
    batcher.submit(streams[0].request(0)).result(timeout=ANSWER_TIMEOUT_S)
    return {"corpus": corpus.titles, "svc": svc, "service": service,
            "batcher": batcher, "streams": streams}


def window(state, cell, log, tracer, spans):
    service, batcher = state["service"], state["batcher"]
    streams = state["streams"]
    s0, b0 = copy.deepcopy(service.stats), dict(batcher.stats)
    done = [[] for _ in streams]
    go = threading.Barrier(len(streams) + 1)
    clock = {}

    def client(c):
        stream, out = streams[c], done[c]
        go.wait()
        stop = clock["stop"]
        k = 0
        while time.perf_counter() < stop:
            req = stream.request(k % len(stream))
            ts = time.perf_counter()
            try:
                resp = batcher.submit(req).result(timeout=ANSWER_TIMEOUT_S)
                err = None
            except Exception as e:   # no answer: counted as failed
                resp, err = None, repr(e)
            out.append((k % len(stream), len(req), ts, time.perf_counter(),
                        resp, err))
            k += 1

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(len(streams))]
    for th in threads:
        th.start()
    counter = _RowCounter(_program()[0]) if tracer.on else None
    log.open = True
    with tracer.window(), spans, (counter or contextlib.nullcontext()):
        t0 = time.perf_counter()
        clock["stop"] = t0 + cell.seconds
        go.wait()
        for th in threads:
            th.join(cell.seconds + 2 * ANSWER_TIMEOUT_S)
        hung = sum(th.is_alive() for th in threads)
        t1 = max([t0] + [r[3] for out in done for r in out])
    log.open = False
    s1, b1 = service.stats, batcher.stats
    reqs = [(c,) + r for c, out in enumerate(done) for r in out]
    answered = [r for r in reqs if r[6] is None]
    return {"kind": "service", "window_s": t1 - t0,
            "queries": sum(r[2] for r in answered),
            "requests": reqs, "hung_clients": hung,
            "latencies_ms": [(r[4] - r[3]) * 1e3 for r in answered],
            "service": {k: s1[k] - s0[k] for k in
                        ("batches", "queries", "planned_pairs", "seconds")},
            "batcher": {k: b1[k] - b0[k] for k in
                        ("requests", "queries", "super_batches")},
            "live_pairs": s1["planned_pairs"] - s0["planned_pairs"],
            "rows_touched": counter.rows if counter else None,
            "feature_dim": int(state["svc"]["feature_dim"]),
            "calls": log.take()}


def _sample(state, record, cell):
    """Requests to hold to the reference, drawn from the seed: every one
    that leads with a special query, then others in a random order until
    the reference's pairs reach ``check_pairs``."""
    corpus, svc = state["corpus"], state["svc"]
    k = int(svc["prefix_len"])
    size = collections.Counter(prefix_key(t, k) for t in corpus)
    n_null = size.get(None, 0)
    reqs = [r for r in record["requests"] if r[6] is None]
    rng = np.random.default_rng([int(cell.seed), 104729])
    order = rng.permutation(len(reqs))
    titles = [state["streams"][r[0]].request(r[1]) for r in reqs]

    seen = set()

    def pairs(ts):
        """Pairs the reference scores anew for these titles."""
        new = [t for t in ts if t not in seen]
        seen.update(new)
        return sum(len(corpus) if prefix_key(t, k) is None
                   else size.get(prefix_key(t, k), 0) + n_null for t in new)

    special = [i for i in order if prefix_key(titles[i][0], k) is None
               or prefix_key(titles[i][0], k) not in size]
    first = set(special)
    rest = [i for i in order if i not in first]
    chosen, budget = [], int(cell.check["check_pairs"])
    for i in special + rest:
        if budget <= 0:
            break
        chosen.append(i)
        budget -= pairs(titles[i])
    occ = collections.Counter(t for ts in titles for t in ts)
    return [(titles[i], reqs[i][5]) for i in chosen], occ


def judge(state, record, cell):
    """Hash the survivors, stop the batcher, free the service, then hold
    a sample of the answers and every survivor of its queries to the
    reference."""
    hashes = check.survivor_hashes(record.pop("calls"))
    record["survivors"] = int(hashes[0].size)
    state["batcher"].close()
    sample, occ = _sample(state, record, cell)
    corpus, svc = state["corpus"], state["svc"]
    failed = (sum(1 for r in record["requests"] if r[6] is not None)
              + record["hung_clients"])
    state.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    distinct = sorted({t for req, _ in sample for t in req})
    want = check.service_expected(corpus, distinct, svc, cell.device)
    record["checked_requests"] = len(sample)
    return check.service_numbers(want, sample, occ, hashes, failed)

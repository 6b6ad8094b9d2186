"""Batch traffic: one-shot ``run_er`` over the whole corpus, back to back.

Set-up makes the corpus and runs ``run_er`` once (the kernel library is
built or loaded there, and every shape of the cell is met). The window
runs ``run_er`` again and again and closes at the end of the first run
that ends after ``--seconds``, so it holds whole runs only.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import check
from ..data import make_corpus
from ..reference.er import prefix_key

SPANS = (("featurize", "encode.featurize"), ("plan_job", "compiler.plan_job"),
         ("_lower_plan", "compiler.lower"),
         ("schedule_tiles", "compiler.schedule"), ("execute", "stage1.execute"),
         ("verify_pairs", "stage2.verify_pairs"))


def _program():
    from repro_torch.er import pipeline
    return pipeline


def survivor_modules():
    return [_program()]


def span_targets():
    p = _program()
    return [(p, attr, name) for attr, name in SPANS]


def setup(cell):
    pipeline = _program()
    corpus = make_corpus(cell.config["data"], cell.seed)
    er = dict(cell.config["run_er"], **cell.traffic.get("run_er", {}))
    if er.get("strategy") != "sorted_neighborhood" and \
            int(er["prefix_len"]) != corpus.key_width:
        raise ValueError("prefix_len differs from the corpus's key width")
    cfg = pipeline.ERConfig(**er)
    pipeline.run_er(corpus.titles, cfg, device=cell.device)
    return {"titles": corpus.titles, "er": er, "cfg": cfg}


def window(state, cell, log, tracer, spans):
    run_er = _program().run_er
    titles, cfg = state["titles"], state["cfg"]
    runs = []
    log.open = True
    with tracer.window(), spans:
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            try:
                res = run_er(titles, cfg, device=cell.device)
            except Exception as e:          # counted as a failed run
                runs.append({"error": repr(e), "calls": log.take()})
                break
            te = time.perf_counter()
            runs.append({"matches": res.matches, "total_pairs": res.total_pairs,
                         "timings": dict(res.extra["timings"]),
                         "seconds": te - ts, "calls": log.take()})
            if te - t0 >= cell.seconds:
                break
        t1 = time.perf_counter()
    log.open = False
    done = [r for r in runs if "error" not in r]
    return {"kind": "batch", "window_s": t1 - t0,
            "entities": len(titles) * len(done), "runs": runs,
            "live_pairs": sum(r["total_pairs"] for r in done),
            "feature_dim": int(state["er"]["feature_dim"])}


def rows_touched(titles, er) -> int:
    """Entity rows stage 1 reads in one run: every entity in a block of
    two or more (all of them for SN), and with key-less entities the
    whole input once more for the match_⊥ job."""
    if er.get("strategy") == "sorted_neighborhood":
        return len(titles)
    keys = [prefix_key(t, int(er["prefix_len"])) for t in titles]
    _, counts = np.unique([k for k in keys if k is not None],
                          return_counts=True)
    n_null = sum(k is None for k in keys)
    extra = len(titles) + n_null if n_null else 0
    return int(counts[counts >= 2].sum()) + extra


def judge(state, record, cell):
    """Hash every run's survivors, free the program's state, then hold
    each run to the reference."""
    for run in record["runs"]:
        run["survivor_hashes"] = check.survivor_hashes(run.pop("calls"))
    record["survivors"] = sum(r["survivor_hashes"][0].size
                              for r in record["runs"])
    record["rows_touched"] = rows_touched(state["titles"], state["er"]) * \
        sum(1 for r in record["runs"] if "error" not in r)
    titles, er = state["titles"], state["er"]
    state.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    want = check.batch_expected(titles, er, er.get("strategy", "pair_range"),
                                cell.device)
    return check.batch_numbers(record["runs"], want)

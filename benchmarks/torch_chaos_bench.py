"""Chaos drill for the port's fault-tolerant runtime (torch leg of
``chaos_bench``): seeded failure scripts — device kills, revives,
stragglers, transient errors, corrupted shards, up to n_dev − 1
concurrent fatal devices — injected into an 8-device supervised run over
the paper's Fig. 9 robustness workload (b = 100 blocks,
|Φ_k| ∝ e^{−s·k}, s = 1.0). The 8 devices are logical shards of the one
device the leg runs on; stage 1 runs K1 on the card.

Two drills, asserted as the JAX leg's (exact, not clocks):
  * **executor** — ``execute_supervised`` under every script returns
    exactly the failure-free survivor set, coverage 1.0, no lost tile,
    retries within the bound;
  * **service** — a supervised :class:`ERService` serves the same traffic
    as a quiet one under kills, a corruption and later revives, batch for
    batch, with the circuit breaker evicting and re-admitting devices.

    PYTHONPATH=src python -m benchmarks.torch_chaos_bench [--quick] [--device cpu|cuda]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import (compute_bdm, plan_basic, plan_block_split,
                              plan_pair_range)
from repro_torch.device import resolve_device
from repro_torch.er import ERService, ServiceConfig, make_products
from repro_torch.er.blocking import exponential_block_ids
from repro_torch.er.compiler import (FaultEvent, FaultInjector, FaultScript,
                                     execute, execute_supervised, lower,
                                     plan_to_job)

from .common import print_table, save_rows, timer
from .torch_common import cli, count_view, impl_of

N_DEV = 8
THRESH = 0.4
STRATEGIES = {"basic": plan_basic, "block_split": plan_block_split,
              "pair_range": plan_pair_range}
# The columns that equal the JAX leg's row for row (the rest are clocks).
COUNTS = ("drill", "strategy", "seed", "events", "rounds", "retries",
          "recovered_tiles", "failed_shards", "coverage", "exact", "batch",
          "queries", "matches", "attempts", "evictions", "readmissions")


def _workload(n: int, r: int):
    """Fig. 9 robustness blocking at s = 1.0, lowered per strategy."""
    rng = np.random.default_rng(9)
    bid = exponential_block_ids(n, b=100, s=1.0, rng=rng)
    bdm = compute_bdm(bid, np.zeros(n, np.int64), int(bid.max()) + 1, 1)
    feats = rng.normal(size=(n, 64)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    cats = {name: lower(plan_to_job(mk(bdm, r)), 64, 64)
            for name, mk in STRATEGIES.items()}
    return cats, feats


def _pairs(ra, rb):
    return set(zip(ra.tolist(), rb.tolist()))


def executor_drill(n: int, r: int, n_scripts: int, dev):
    cats, feats = _workload(n, r)
    feats = torch.from_numpy(feats).to(dev)
    impl = impl_of(dev)
    rows = []
    for strat, cat in cats.items():
        want = _pairs(*execute(cat, feats, threshold=THRESH, impl=impl,
                               device=dev))
        for seed in range(n_scripts):
            n_events = 4 + seed
            script = FaultScript.random(seed, N_DEV, n_events,
                                        max_step=24, straggle_delay=1e6,
                                        allow_revive=True)
            max_retries = n_events + 2
            with timer() as t:
                ra, rb, rep = execute_supervised(
                    cat, feats, threshold=THRESH, n_dev=N_DEV,
                    shard_deadline=120.0, max_retries=max_retries,
                    backoff=0.0, injector=FaultInjector(script, seed=seed),
                    impl=impl, device=dev)
            assert _pairs(ra, rb) == want, (strat, seed)
            assert rep.coverage == 1.0 and rep.lost_tiles == 0, (strat, seed)
            assert rep.retries <= max_retries, (strat, seed)
            statuses = [rec.status for rec in rep.records]
            rows.append({
                "drill": "executor", "strategy": strat, "seed": seed,
                "events": len(script.events), "rounds": rep.rounds,
                "retries": rep.retries,
                "recovered_tiles": rep.recovered_tiles,
                "failed_shards": sum(s != "ok" for s in statuses),
                "coverage": rep.coverage,
                "recovery_s": round(t.seconds, 4),
                # real wall seconds vs injected virtual delay, split per
                # record — chaos scripts must not poison latency stats
                "shard_real_s": round(sum(rec.elapsed
                                          for rec in rep.records), 4),
                "shard_injected_s": round(sum(rec.injected_delay
                                              for rec in rep.records), 4),
                "exact": True,
            })
    return rows


def service_drill(n_corpus: int, n_batches: int, batch: int, dev):
    ds = make_products(n_corpus + n_batches * batch, seed=3)
    corpus = ds.titles[:n_corpus]
    batches = [ds.titles[n_corpus + i * batch:n_corpus + (i + 1) * batch]
               for i in range(n_batches)]
    cfg = dict(feature_dim=128, max_len=48, r=8, m=4,
               query_buckets=(batch,), tile_chunk=64,
               kernel_impl=impl_of(dev))

    quiet = ERService(corpus, ServiceConfig(**cfg), device=dev)
    want = [set(quiet.match(b)) for b in batches]

    svc = ERService(corpus, ServiceConfig(
        exec_devices=N_DEV, backoff_s=0.0, breaker_threshold=1,
        breaker_cooldown_s=0.0, **cfg), device=dev)
    svc.set_fault_injector(FaultInjector(FaultScript(events=(
        FaultEvent("kill", 2, 0),
        FaultEvent("kill", 5, 3),
        FaultEvent("corrupt", 1, 5),
        FaultEvent("revive", 2, 30),
        FaultEvent("revive", 5, 30)), n_dev=N_DEV)))
    rows = []
    for i, (b, w) in enumerate(zip(batches, want)):
        with timer() as t:
            resp = svc.match(b)
        assert set(resp) == w, f"batch {i} diverged under chaos"
        assert resp.coverage == 1.0 and not resp.degraded, i
        rows.append({
            "drill": "service", "batch": i, "queries": len(b),
            "matches": len(resp), "attempts": resp.attempts,
            "recovered_tiles": resp.recovered_tiles,
            "coverage": resp.coverage, "seconds": round(t.seconds, 4),
            "exact": True,
        })
    s = svc.stats
    assert s["degraded"] == 0
    assert s["breaker_evictions"] >= 1, "kills never tripped the breaker"
    assert s["breaker_readmissions"] >= 1, "revive was never probed back"
    rows.append({
        "drill": "service", "batch": "total", "queries": s["queries"],
        "matches": s["matches"], "attempts": s["retries"],
        "recovered_tiles": s["recovered_tiles"], "coverage": 1.0,
        "seconds": round(s["seconds"], 4), "exact": True,
        "evictions": s["breaker_evictions"],
        "readmissions": s["breaker_readmissions"],
    })
    return rows


def measure(n: int = 4_000, r: int = 32, n_scripts: int = 6,
            n_corpus: int = 300, n_batches: int = 12, batch: int = 16,
            quick: bool = False, device="cuda"):
    dev = resolve_device(device)
    if quick:
        n, n_scripts = 1_200, 3
        n_corpus, n_batches = 200, 6
    rows = executor_drill(n, r, n_scripts, dev)
    rows += service_drill(n_corpus, n_batches, batch, dev)
    exec_rows = [row for row in rows if row["drill"] == "executor"]
    print_table(
        f"chaos_bench — executor drill on {dev} (n={n}, s=1.0, "
        f"n_dev={N_DEV}, {n_scripts} scripts × {len(STRATEGIES)} "
        f"strategies)", exec_rows,
        cols=["strategy", "seed", "events", "rounds", "retries",
              "recovered_tiles", "failed_shards", "coverage",
              "recovery_s", "shard_real_s", "shard_injected_s", "exact"])
    svc_rows = [row for row in rows if row["drill"] == "service"]
    print_table("chaos_bench — service drill (kills + revive, breaker)",
                svc_rows,
                cols=["batch", "queries", "matches", "attempts",
                      "recovered_tiles", "coverage", "seconds", "exact"])
    path = save_rows("torch_chaos_bench", rows)
    worst = max(row["retries"] for row in exec_rows)
    print(f"\nall scripts recovered to the exact quiet match set "
          f"(coverage 1.0, worst retries {worst}) — {path}")
    return rows


def counts(rows):
    """The count columns, in row order."""
    return count_view(rows, COUNTS)


def check(rows):
    """No wall-time bar in this leg: its asserts are exact."""


def run(n: int = 4_000, quick: bool = False, device="cuda"):
    rows = measure(n, quick=quick, device=device)
    check(rows)
    return rows


if __name__ == "__main__":
    raise SystemExit(cli(run, __doc__))

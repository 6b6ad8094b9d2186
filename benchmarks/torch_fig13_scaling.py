"""Figs. 13/14 on the port — scalability with the number of nodes n (DS1
and DS2) (torch leg of ``fig13_scaling``).

Paper setup: m = 2n map tasks, r = 10n reduce tasks, n ∈ [1, 100].
Makespans are modeled from EXACT plan load distributions (the port's
numpy plans, equal to the JAX leg's row for row) with a cost per pair
measured on the leg's device:

    makespan(n) = max_k(load_k) · cost_per_pair / cores_per_node(2)
                  + bdm_overhead(n)

so ``makespan_s`` and ``speedup`` are the card's clocks (the matching
time of ``run_er`` on 8,000 products, ``reducer_seconds``, after a first
run that builds and loads the kernels), not the JAX leg's. Every
strategy row also carries the exact per-device bytes each stage-1
gather policy would move at that node count
(``compiler.comms_volume`` over the strategy's lowered 128 × 128 tile
catalog). DS2 runs plan math only (no pair is materialized).

A measured part re-runs the small-n points in-process on meshes of n
LOGICAL shards of the leg's one device (``make_er_mesh(n, devices=[dev]
* n)``) with flat and ring comms: the executor's own byte counters, and
match-set equality against the one-device run (asserted). Its
``makespan_s`` is one card's wall time with every shard on it.

    PYTHONPATH=src python -m benchmarks.torch_fig13_scaling [--quick] [--device cpu|cuda]
"""
from __future__ import annotations

import time
from dataclasses import replace

import numpy as np

from repro_torch.core import (compute_bdm, plan_basic, plan_block_split,
                              plan_pair_range)
from repro_torch.device import resolve_device
from repro_torch.er import ERConfig, make_products, make_publications, run_er
from repro_torch.er.blocking import prefix_block_ids
from repro_torch.er.compiler import (comms_volume, lower, plan_to_job,
                                     stage1_stats)
from repro_torch.sharding import make_er_mesh

from .common import print_table, save_rows
from .torch_common import cli, count_view, impl_of

NODES = (1, 2, 5, 10, 20, 40, 100)
MEASURED_NODES = (2, 4, 8)
STRATEGIES = ("basic", "block_split", "pair_range")
# The columns that equal the JAX leg's row for row (makespans and
# speedups follow from the measured cost per pair).
COUNTS = ("dataset", "nodes", "strategy", "max_core_load", "flat_gather_B",
          "ring_B", "hier_B", "ring_hops")


def _measure_cost_per_pair(dev, n_sample: int = 8_000) -> float:
    """Matching seconds per planned pair of ``run_er`` on ``n_sample``
    products, from the second of two runs: the first builds and loads
    the kernels, which is no cost of a pair."""
    ds = make_products(n_sample)
    cfg = ERConfig(strategy="pair_range", r=16, m=8, kernel_impl=impl_of(dev))
    run_er(ds.titles, cfg, device=dev)
    res = run_er(ds.titles, cfg, device=dev)
    return float(res.reducer_seconds.sum()) / max(res.total_pairs, 1)


def _bdm_overhead(n_entities: int, n_nodes: int) -> float:
    # one counting pass over the entities, spread over nodes + fixed job cost
    return 2e-7 * n_entities / n_nodes + 1.0


def modeled(ds1_n: int, ds2_n: int, cpp: float) -> list:
    """The plan-math rows for DS1 and DS2 at every node count in NODES."""
    rows = []
    for make, nn, tag in ((make_products, ds1_n, "DS1"),
                          (make_publications, ds2_n, "DS2")):
        ds = make(nn)
        bid, _ = prefix_block_ids(ds.titles, ds.prefix_len)
        n_ent = ds.n
        for n in NODES:
            m, r = 2 * n, 10 * n
            part = np.minimum(np.arange(n_ent) * m // n_ent, m - 1)
            bdm = compute_bdm(bid, part, int(bid.max()) + 1, m)
            plans = {"basic": plan_basic(bdm, r),
                     "block_split": plan_block_split(bdm, r),
                     "pair_range": plan_pair_range(bdm, r)}
            for strat, plan in plans.items():
                # r = 10n reducers over n nodes of 2 cores, round-robin
                node_of = np.arange(r) % (2 * n)
                core_loads = np.bincount(node_of, weights=plan.reducer_pairs,
                                         minlength=2 * n)
                makespan = core_loads.max() * cpp + _bdm_overhead(n_ent, n)
                vol = comms_volume(lower(plan_to_job(plan), 128, 128),
                                   n_ent, n, feature_dim=128)
                rows.append({
                    "dataset": tag, "nodes": n, "strategy": strat,
                    "max_core_load": int(core_loads.max()),
                    "makespan_s": round(float(makespan), 4),
                    "flat_gather_B": vol["flat_gather"],
                    "ring_B": vol["ring"],
                    "hier_B": vol["hier_intra"] + vol["hier_inter"],
                    "ring_hops": vol["ring_hops"],
                })
    for tag in ("DS1", "DS2"):
        for strat in STRATEGIES:
            sel = [r for r in rows
                   if r["dataset"] == tag and r["strategy"] == strat]
            base = sel[0]["makespan_s"]
            for r in sel:
                r["speedup"] = round(base / r["makespan_s"], 2)
    return rows


def measured(quick: bool, dev) -> list:
    """PairRange on n logical shards of ``dev`` with flat and ring comms,
    each run's match set asserted equal to the one-device run's."""
    rows = []
    n_corpus = 1500 if quick else 3000
    titles = make_products(n_corpus, seed=1).titles
    for n_dev in (MEASURED_NODES[:2] if quick else MEASURED_NODES):
        cfg = ERConfig(strategy="pair_range", r=10 * n_dev, m=2 * n_dev,
                       feature_dim=128, max_len=48, kernel_impl=impl_of(dev))
        host = run_er(titles, cfg, device=dev)
        mesh = make_er_mesh(n_dev, devices=[dev] * n_dev)
        for comms in ("flat", "ring"):
            before = dict(stage1_stats["interconnect"])
            t0 = time.perf_counter()
            res = run_er(titles, replace(cfg, comms=comms), mesh=mesh,
                         device=dev)
            wall = time.perf_counter() - t0
            after = stage1_stats["interconnect"]
            assert res.matches == host.matches, \
                f"measured mesh run diverged at n={n_dev}, {comms}"
            rows.append({
                "dataset": "DS1-measured", "nodes": n_dev,
                "strategy": f"pair_range/{comms}",
                "makespan_s": round(wall, 4),
                "flat_gather_B": after["flat_bytes"] - before["flat_bytes"],
                "ring_B": after["ring_bytes"] - before["ring_bytes"],
            })
    return rows


def measure(ds1_n: int = 114_000, ds2_n: int = 1_390_000,
            quick: bool = False, device="cuda"):
    dev = resolve_device(device)
    if quick:
        ds1_n, ds2_n = 20_000, 60_000
    rows = modeled(ds1_n, ds2_n, _measure_cost_per_pair(dev))
    rows.extend(measured(quick, dev))
    print_table(f"Figs. 13/14 — node scalability (modeled from a cost per "
                f"pair measured on {dev}; DS1-measured: logical shards of "
                f"ONE {dev}, its wall time)", rows)
    save_rows("torch_fig13_scaling", rows)
    return rows


def counts(rows):
    """The count columns, in row order."""
    return count_view(rows, COUNTS)


def check(rows):
    """No bar in this leg; the JAX leg asserts only what :func:`measured`
    asserts (equal match sets)."""


def run(ds1_n: int = 114_000, ds2_n: int = 1_390_000, quick: bool = False,
        device="cuda"):
    rows = measure(ds1_n, ds2_n, quick=quick, device=device)
    check(rows)
    return rows


if __name__ == "__main__":
    raise SystemExit(cli(run, __doc__))

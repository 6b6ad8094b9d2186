"""Cost-LPT vs round-robin tile scheduling at Fig. 9 skews, on the port
(torch leg of ``schedule_bench``).

b = 100 blocks with |Φ_k| ∝ e^{−s·k}, s ∈ {0.0, 0.5, 1.0}; every
strategy's plan lowers to a tile catalog through the port's compiler
(numpy copies), and the two policies schedule identical catalogs onto
``n_dev`` devices. Every column but the ``*_sched_ms`` wall times equals
the JAX leg's. Asserted, as the JAX leg: cost-LPT is never worse than
round-robin beyond one tile quantum, and strictly better for Basic at
s = 1.0. Host only; ``--device`` is checked as every leg's.

    PYTHONPATH=src python -m benchmarks.torch_schedule_bench [--quick] [--device cpu|cuda]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import (compute_bdm, plan_basic, plan_block_split,
                              plan_pair_range)
from repro_torch.device import resolve_device
from repro_torch.er.blocking import exponential_block_ids
from repro_torch.er.compiler import lower, plan_to_job, schedule_tiles

from .common import print_table, save_rows, timer
from .torch_common import cli, count_view

SKEWS = (0.0, 0.5, 1.0)
STRATEGIES = (("basic", plan_basic), ("block_split", plan_block_split),
              ("pair_range", plan_pair_range))
# The columns that equal the JAX leg's row for row (the rest are clocks).
COUNTS = ("s", "strategy", "pairs", "tiles", "rr_imbalance",
          "rr_makespan_pairs", "lpt_imbalance", "lpt_makespan_pairs",
          "quantum", "win")


def measure(n: int = 20_000, b: int = 100, m: int = 20, r: int = 32,
            n_dev: int = 8, quick: bool = False, device="cuda"):
    resolve_device(device)
    if quick:
        n = 6_000
    rng = np.random.default_rng(7)
    part = np.minimum(np.arange(n, dtype=np.int64) * m // n, m - 1)
    rows = []
    for s in SKEWS:
        bid = exponential_block_ids(n, b=b, s=s, rng=rng)
        bdm = compute_bdm(bid, part, int(bid.max()) + 1, m)
        for strat, mk_plan in STRATEGIES:
            plan = mk_plan(bdm, r)
            catalog = lower(plan_to_job(plan))
            row = {"s": s, "strategy": strat, "pairs": plan.total_pairs,
                   "tiles": catalog.num_tiles}
            quantum = 0
            for key, policy in (("rr", "round_robin"), ("lpt", "cost_lpt")):
                with timer() as t:
                    sched = schedule_tiles(catalog, n_dev=n_dev,
                                           policy=policy)
                stats = sched.stats()["device"]
                row[f"{key}_imbalance"] = round(stats["imbalance"], 3)
                row[f"{key}_makespan_pairs"] = int(stats["max"])
                row[f"{key}_sched_ms"] = round(t.seconds * 1e3, 2)
                quantum = max(quantum, int(sched.tile_cost.max())
                              if sched.tile_cost.size else 0)
            row["quantum"] = quantum
            row["win"] = round(row["rr_makespan_pairs"]
                               / max(row["lpt_makespan_pairs"], 1), 2)
            rows.append(row)
    print_table(f"schedule_bench — cost-LPT vs round-robin device loads "
                f"(n={n}, b={b}, r={r}, n_dev={n_dev})", rows)
    save_rows("torch_schedule_bench", rows)
    # The JAX leg's bars (counts, not clocks): never worse than one tile
    # quantum; strictly better where the paper says balancing matters.
    for row in rows:
        assert (row["lpt_makespan_pairs"]
                <= row["rr_makespan_pairs"] + row["quantum"]), row
    headline = [row for row in rows
                if row["s"] == 1.0 and row["strategy"] == "basic"]
    for row in headline:
        assert row["lpt_imbalance"] < row["rr_imbalance"], row
        assert row["lpt_makespan_pairs"] < row["rr_makespan_pairs"], row
        print(f"Basic @ s=1.0: device imbalance {row['rr_imbalance']} → "
              f"{row['lpt_imbalance']} ({row['win']}× makespan win)")
    return rows


def counts(rows):
    """The count columns, in row order."""
    return count_view(rows, COUNTS)


def check(rows):
    """No wall-time bar in this leg."""


def run(n: int = 20_000, quick: bool = False, device="cuda"):
    rows = measure(n, quick=quick, device=device)
    check(rows)
    return rows


if __name__ == "__main__":
    raise SystemExit(cli(run, __doc__))

"""Fig. 9 on the port — robustness against data skew (torch leg of
``fig9_skew``).

Blocking is the controlled exponential distribution over b = 100 blocks,
|Φ_k| ∝ e^{−s·k}, s ∈ [0, 1] (m = 20, r = 100), through the port's
``run_er`` for Basic, BlockSplit and PairRange. The columns are the JAX
leg's: the plan's pairs and reducer loads (equal to the JAX leg's row for
row) and the modeled makespan from the measured matching time (the
card's). Stage 1 runs the catalog kernels (K1, K2 on overflow).

    PYTHONPATH=src python -m benchmarks.torch_fig9_skew [--quick] [--device cpu|cuda]
"""
from __future__ import annotations

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.er import ERConfig, make_products, run_er
from repro_torch.er.blocking import exponential_block_ids

from .common import print_table, save_rows
from .torch_common import cli, count_view, impl_of

SKEWS = (0.0, 0.25, 0.5, 0.75, 1.0)
STRATEGIES = ("basic", "block_split", "pair_range")
# The columns that equal the JAX leg's row for row (the rest are clocks).
COUNTS = ("s", "strategy", "pairs", "max_load", "mean_load", "imbalance")


def measure(n: int = 20_000, quick: bool = False, device="cuda"):
    dev = resolve_device(device)
    if quick:
        n = 8_000
    ds = make_products(n)
    rng = np.random.default_rng(7)
    rows = []
    for s in SKEWS:
        block_ids = exponential_block_ids(ds.n, b=100, s=s, rng=rng)
        for strat in STRATEGIES:
            cfg = ERConfig(strategy=strat, r=100, m=20,
                           kernel_impl=impl_of(dev))
            res = run_er(ds.titles, cfg, block_ids=block_ids, device=dev)
            total_pairs = res.total_pairs
            work_s = float(res.reducer_seconds.sum())
            cost_per_pair = work_s / max(total_pairs, 1)
            modeled = (res.reducer_pairs.max() * cost_per_pair
                       + res.bdm_seconds)
            rows.append({
                "s": s, "strategy": strat, "pairs": total_pairs,
                "max_load": int(res.reducer_pairs.max()),
                "mean_load": float(res.reducer_pairs.mean()),
                "imbalance": round(float(res.reducer_pairs.max()
                                         / max(res.reducer_pairs.mean(), 1)), 2),
                "modeled_makespan_s": round(modeled, 4),
                "ms_per_1e4_pairs": round(1e4 * modeled / max(total_pairs, 1) * 1e3, 4),
            })
    print_table(f"Fig. 9 — skew robustness on {dev} (modeled makespan per "
                f"10^4 pairs)", rows)
    save_rows("torch_fig9_skew", rows)
    return rows


def counts(rows):
    """The count columns, in row order."""
    return count_view(rows, COUNTS)


def check(rows):
    """The JAX leg asserts no bar here; it prints the paper's headline,
    Basic against the balanced strategies at s = 1."""
    at1 = {r["strategy"]: r["modeled_makespan_s"] for r in rows if r["s"] == 1.0}
    ratio = at1["basic"] / max(min(at1["block_split"], at1["pair_range"]), 1e-9)
    print(f"Basic/balanced makespan ratio at s=1.0: {ratio:.1f}× "
          f"(paper: >12×)")


def run(n: int = 20_000, quick: bool = False, device="cuda"):
    rows = measure(n, quick=quick, device=device)
    check(rows)
    return rows


if __name__ == "__main__":
    raise SystemExit(cli(run, __doc__))

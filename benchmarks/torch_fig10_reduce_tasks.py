"""Fig. 10 on the port — the number of reduce tasks r (torch leg of
``fig10_reduce_tasks``): DS1-like products, m = 20, r ∈ {20 … 160},
through the port's ``run_er`` for Basic, BlockSplit and PairRange. Loads,
imbalance and map output equal the JAX leg's row for row; the modeled
makespan comes from the measured matching time. Stage 1 runs K1.

    PYTHONPATH=src python -m benchmarks.torch_fig10_reduce_tasks [--quick] [--device cpu|cuda]
"""
from __future__ import annotations

from repro_torch.device import resolve_device
from repro_torch.er import ERConfig, make_products, run_er

from .common import print_table, save_rows
from .torch_common import cli, count_view, impl_of

RS = (20, 40, 80, 120, 160)
STRATEGIES = ("basic", "block_split", "pair_range")
# The columns that equal the JAX leg's row for row (the rest are clocks).
COUNTS = ("r", "strategy", "max_load", "imbalance", "map_kv_pairs")


def measure(n: int = 20_000, quick: bool = False, device="cuda"):
    dev = resolve_device(device)
    if quick:
        n = 8_000
    ds = make_products(n)
    rows = []
    for r in RS:
        for strat in STRATEGIES:
            res = run_er(ds.titles, ERConfig(strategy=strat, r=r, m=20,
                                             kernel_impl=impl_of(dev)),
                         device=dev)
            cpp = float(res.reducer_seconds.sum()) / max(res.total_pairs, 1)
            modeled = res.reducer_pairs.max() * cpp + res.bdm_seconds
            rows.append({
                "r": r, "strategy": strat,
                "max_load": int(res.reducer_pairs.max()),
                "imbalance": round(float(res.reducer_pairs.max()
                                         / max(res.reducer_pairs.mean(), 1)), 2),
                "map_kv_pairs": res.map_output_size,
                "modeled_makespan_s": round(modeled, 4),
            })
    print_table(f"Fig. 10 — vary r on {dev} (modeled makespan)", rows)
    save_rows("torch_fig10_reduce_tasks", rows)
    return rows


def counts(rows):
    """The count columns, in row order."""
    return count_view(rows, COUNTS)


def check(rows):
    """No bar (as the JAX leg): the balanced strategies' speedup over
    Basic at r = 160."""
    b160 = [r for r in rows if r["r"] == 160]
    basic = next(r for r in b160 if r["strategy"] == "basic")
    best = min(r["modeled_makespan_s"] for r in b160
               if r["strategy"] != "basic")
    print(f"speedup of balanced vs Basic at r=160: "
          f"{basic['modeled_makespan_s'] / max(best, 1e-9):.1f}× (paper: 6×)")


def run(n: int = 20_000, quick: bool = False, device="cuda"):
    rows = measure(n, quick=quick, device=device)
    check(rows)
    return rows


if __name__ == "__main__":
    raise SystemExit(cli(run, __doc__))

"""Fig. 11 on the port — sorted input data (torch leg of
``fig11_sorted``): BlockSplit and PairRange through the port's ``run_er``
on DS1-like products, unsorted and sorted by title. Loads and imbalance
equal the JAX leg's row for row; the modeled makespan comes from the
measured matching time. Stage 1 runs K1.

    PYTHONPATH=src python -m benchmarks.torch_fig11_sorted [--quick] [--device cpu|cuda]
"""
from __future__ import annotations

from repro_torch.device import resolve_device
from repro_torch.er import ERConfig, make_products, run_er

from .common import print_table, save_rows
from .torch_common import cli, count_view, impl_of

STRATEGIES = ("block_split", "pair_range")
# The columns that equal the JAX leg's row for row (the rest are clocks).
COUNTS = ("strategy", "input", "max_load", "imbalance")


def measure(n: int = 20_000, quick: bool = False, device="cuda"):
    dev = resolve_device(device)
    if quick:
        n = 8_000
    ds = make_products(n)
    variants = {
        "unsorted": ds.titles,
        "sorted": sorted(ds.titles),
    }
    rows = []
    for order, titles in variants.items():
        for strat in STRATEGIES:
            res = run_er(titles, ERConfig(strategy=strat, r=100, m=20,
                                          kernel_impl=impl_of(dev)),
                         device=dev)
            cpp = float(res.reducer_seconds.sum()) / max(res.total_pairs, 1)
            modeled = res.reducer_pairs.max() * cpp + res.bdm_seconds
            rows.append({
                "strategy": strat, "input": order,
                "max_load": int(res.reducer_pairs.max()),
                "imbalance": round(float(res.reducer_pairs.max()
                                         / max(res.reducer_pairs.mean(), 1)), 2),
                "modeled_makespan_s": round(modeled, 4),
            })
    print_table(f"Fig. 11 — sorted vs unsorted input on {dev}", rows)
    save_rows("torch_fig11_sorted", rows)
    return rows


def counts(rows):
    """The count columns, in row order."""
    return count_view(rows, COUNTS)


def check(rows):
    """No bar (as the JAX leg): each strategy's sorted-input degradation."""
    for strat in STRATEGIES:
        u = next(r for r in rows if r["strategy"] == strat and r["input"] == "unsorted")
        s = next(r for r in rows if r["strategy"] == strat and r["input"] == "sorted")
        pct = 100 * (s["modeled_makespan_s"] / max(u["modeled_makespan_s"], 1e-9) - 1)
        print(f"{strat}: sorted-input degradation {pct:+.0f}% "
              f"(paper: {'+80%' if strat == 'block_split' else '+13%'})")


def run(n: int = 20_000, quick: bool = False, device="cuda"):
    rows = measure(n, quick=quick, device=device)
    check(rows)
    return rows


if __name__ == "__main__":
    raise SystemExit(cli(run, __doc__))

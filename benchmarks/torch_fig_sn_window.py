"""Sorted Neighborhood window sweep on the port (torch leg of
``fig_sn_window``).

Sweeps w ∈ {10, 100, 1000} through the port's ``run_er`` with
``strategy="sorted_neighborhood"`` and reports, per window, the JAX leg's
columns: exact band pairs, planned reducer imbalance, closed-form map
output, band-catalog tiles, matches and recall (all equal to the JAX
leg's row for row), and the sort, match and wall seconds (the card's).
Stage 1 runs K1 on the band tiles. Asserted, as the JAX leg's ``main``:
the band partition stays balanced (imbalance ≤ 1.2) at every w.

    PYTHONPATH=src python -m benchmarks.torch_fig_sn_window [--quick] [--device cpu|cuda] [--n N] [--r R]
"""
from __future__ import annotations

from repro_torch.device import resolve_device
from repro_torch.er import ERConfig, make_products, run_er

from .common import print_table, save_rows, timer
from .torch_common import cli, count_view, impl_of

WINDOWS = (10, 100, 1000)
IMBALANCE_BAR = 1.2
# The columns that equal the JAX leg's row for row (the rest are clocks).
COUNTS = ("n", "w", "r", "pairs", "imbalance", "map_output", "tiles",
          "matches", "recall")


def measure(n: int = 40_000, r: int = 32, quick: bool = False,
            device="cuda"):
    dev = resolve_device(device)
    if quick:
        n = 6_000
    ds = make_products(n)
    rows = []
    for w in WINDOWS:
        cfg = ERConfig(strategy="sorted_neighborhood", window=w, r=r,
                       kernel_impl=impl_of(dev))
        with timer() as t:
            res = run_er(ds.titles, cfg, device=dev)
        loads = res.reducer_pairs
        recall = (len(res.matches & ds.true_pairs) / len(ds.true_pairs)
                  if ds.true_pairs else 0.0)
        rows.append({
            "n": ds.n, "w": w, "r": r,
            "pairs": res.total_pairs,
            "imbalance": round(float(loads.max() / max(loads.mean(), 1)), 4),
            "map_output": res.map_output_size,
            "tiles": res.extra.get("catalog_tiles", 0),
            "sort_s": round(res.bdm_seconds, 4),
            "match_s": round(float(res.reducer_seconds.sum()), 4),
            "wall_s": round(t.seconds, 4),
            "matches": len(res.matches),
            "recall": round(recall, 4),
        })
    print_table(f"SN window sweep on {dev} — band size, balance, map output",
                rows)
    save_rows("torch_fig_sn_window", rows)
    # the planner's promise: the band partition stays balanced at every w
    assert all(row["imbalance"] <= IMBALANCE_BAR for row in rows), rows
    return rows


def counts(rows):
    """The count columns, in row order."""
    return count_view(rows, COUNTS)


def check(rows):
    """No wall-time bar in this leg."""


def run(n: int = 40_000, r: int = 32, quick: bool = False, device="cuda"):
    rows = measure(n, r, quick=quick, device=device)
    check(rows)
    return rows


if __name__ == "__main__":
    raise SystemExit(cli(run, __doc__, n=40_000, r=32))

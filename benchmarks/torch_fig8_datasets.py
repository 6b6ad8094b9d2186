"""Fig. 8 on the port — dataset statistics: blocks, pairs, largest-block
shares (torch leg of ``fig8_datasets``). Host only: the port's dataset
generators and prefix blocking (numpy copies), so every column but
``blocking_s`` equals the JAX leg's. ``--device`` is checked as every
leg's, though nothing runs on it.

    PYTHONPATH=src python -m benchmarks.torch_fig8_datasets [--quick] [--device cpu|cuda]
"""
from __future__ import annotations

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.er.blocking import prefix_block_ids
from repro_torch.er.datasets import make_products, make_publications

from .common import print_table, save_rows, timer
from .torch_common import cli, count_view

# The columns that equal the JAX leg's row for row (the rest are clocks).
COUNTS = ("dataset", "entities", "blocks", "pairs",
          "largest_block_entities_pct", "largest_block_pairs_pct",
          "true_dups")


def measure(ds1_n: int = 114_000, ds2_n: int = 139_000, quick: bool = False,
            device="cuda"):
    resolve_device(device)
    if quick:
        ds1_n, ds2_n = 20_000, 30_000
    rows = []
    for ds in (make_products(ds1_n), make_publications(ds2_n)):
        with timer() as t:
            bid, _ = prefix_block_ids(ds.titles, ds.prefix_len)
        sizes = np.bincount(bid[bid >= 0])
        pairs = sizes.astype(np.int64) * (sizes.astype(np.int64) - 1) // 2
        rows.append({
            "dataset": ds.name,
            "entities": ds.n,
            "blocks": int(len(sizes)),
            "pairs": int(pairs.sum()),
            "largest_block_entities_pct": round(100 * sizes.max() / ds.n, 2),
            "largest_block_pairs_pct": round(100 * pairs.max() / pairs.sum(), 2),
            "true_dups": len(ds.true_pairs),
            "blocking_s": round(t.seconds, 3),
        })
    print_table("Fig. 8 — dataset statistics", rows)
    save_rows("torch_fig8_datasets", rows)
    return rows


def counts(rows):
    """The count columns, in row order."""
    return count_view(rows, COUNTS)


def check(rows):
    """No bar in this leg."""


def run(ds1_n: int = 114_000, ds2_n: int = 139_000, quick: bool = False,
        device="cuda"):
    rows = measure(ds1_n, ds2_n, quick=quick, device=device)
    check(rows)
    return rows


if __name__ == "__main__":
    raise SystemExit(cli(run, __doc__))

"""Fig. 12 on the port — map output volume (kv-pairs emitted) vs r (torch
leg of ``fig12_map_output``). Host only: exact counts from the port's
plans (numpy copies of Basic, BlockSplit and PairRange), so every column
equals the JAX leg's. ``ici_mbytes`` keeps the JAX leg's name: the
gathered feature bytes, which on the port's mesh are what
``stage1_stats["interconnect"]`` counts. ``--device`` is checked as
every leg's, though nothing runs on it.

    PYTHONPATH=src python -m benchmarks.torch_fig12_map_output [--quick] [--device cpu|cuda]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import (compute_bdm, plan_basic, plan_block_split,
                              plan_pair_range)
from repro_torch.core.pair_range import map_output_size
from repro_torch.device import resolve_device
from repro_torch.er.blocking import prefix_block_ids
from repro_torch.er.datasets import make_products

from .common import print_table, save_rows
from .torch_common import cli, count_view

FEATURE_BYTES = 256 * 4 + 64 + 4   # ngram f32 + codes + length per entity
RS = (20, 40, 80, 120, 160)
# Every column equals the JAX leg's row for row.
COUNTS = ("r", "strategy", "map_kv_pairs", "replication", "ici_mbytes")


def measure(n: int = 20_000, quick: bool = False, device="cuda"):
    resolve_device(device)
    if quick:
        n = 8_000
    ds = make_products(n)
    bid, _ = prefix_block_ids(ds.titles, ds.prefix_len)
    m = 20
    part = np.minimum(np.arange(ds.n) * m // ds.n, m - 1)
    bdm = compute_bdm(bid, part, int(bid.max()) + 1, m)
    rows = []
    for r in RS:
        basic = plan_basic(bdm, r)
        bsplit = plan_block_split(bdm, r)
        prange = plan_pair_range(bdm, r)
        for name, size in (("basic", basic.map_output_size()),
                           ("block_split", bsplit.map_output_size()),
                           ("pair_range", map_output_size(prange))):
            rows.append({
                "r": r, "strategy": name, "map_kv_pairs": int(size),
                "replication": round(size / ds.n, 3),
                "ici_mbytes": round(size * FEATURE_BYTES / 1e6, 1),
            })
    print_table("Fig. 12 — map output volume", rows)
    save_rows("torch_fig12_map_output", rows)
    return rows


def counts(rows):
    """The count columns, in row order."""
    return count_view(rows, COUNTS)


def check(rows):
    """No bar in this leg."""


def run(n: int = 20_000, quick: bool = False, device="cuda"):
    rows = measure(n, quick=quick, device=device)
    check(rows)
    return rows


if __name__ == "__main__":
    raise SystemExit(cli(run, __doc__))

"""PairRange (paper §V, Alg. 2).

All P pairs get a global index via the closed-form enumeration
(core/enumeration.py); the index space is cut into r near-equal ranges and
range k *is* reduce task k. Map sends an entity to every range that contains
at least one of its pairs (the exact union, not just the [Rmin, Rmax] span).

Device mapping: a worker owning range [lo, hi) materializes its pair list with
the vectorized inverse ``p -> (block, x, y)`` and gathers the two feature
rows per pair from the blocked layout. The per-(device, block) *gather set*
is provably a union of <= 2 contiguous row intervals (see
:func:`range_block_intervals`), which is what the collective-volume
accounting (Fig. 12 analog: bytes over ICI) and the sharded executor use.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from . import enumeration as en

__all__ = [
    "PairRangePlan",
    "plan_pair_range",
    "pairs_of_range",
    "range_block_segments",
    "range_block_intervals",
    "entity_range_matrix",
    "map_output_size",
]


@dataclass(frozen=True)
class PairRangePlan:
    r: int
    bdm: np.ndarray            # (b, m)
    block_sizes: np.ndarray    # (b,)
    pair_counts: np.ndarray    # (b,)
    offsets: np.ndarray        # (b,) o(i), exclusive cumsum of pair_counts
    estart: np.ndarray         # (b,) entity-row offset per block (blocked layout)
    bounds: np.ndarray         # (r, 2) [lo, hi) pair-index bounds
    total_pairs: int

    @property
    def reducer_pairs(self) -> np.ndarray:
        return (self.bounds[:, 1] - self.bounds[:, 0]).astype(np.int64)


def plan_pair_range(bdm: np.ndarray, r: int) -> PairRangePlan:
    bdm = np.asarray(bdm, np.int64)
    sizes = bdm.sum(axis=1)
    pairs = en.block_pair_counts(sizes)
    offsets, total = en.pair_offsets(pairs)
    estart = np.concatenate([np.zeros(1, np.int64), np.cumsum(sizes)[:-1]])
    bounds = en.range_bounds(total, r)
    return PairRangePlan(
        r=r, bdm=bdm, block_sizes=sizes, pair_counts=pairs,
        offsets=offsets, estart=estart, bounds=bounds, total_pairs=total)


def pairs_of_range(plan: PairRangePlan, k: int):
    """Materialize range k's pairs: (block, x, y, row_a, row_b) int64 arrays."""
    lo, hi = plan.bounds[k]
    p = np.arange(lo, hi, dtype=np.int64)
    block, x, y = en.invert_pair_index(p, plan.block_sizes, plan.offsets)
    return block, x, y, plan.estart[block] + x, plan.estart[block] + y


def range_block_segments(plan: PairRangePlan, k: int) -> List[Tuple[int, int, int, int, int]]:
    """Per-block pair segments of range k: [(block, x_lo, y_lo, x_hi, y_hi)].

    Range k's pair-index interval [lo, hi) intersected with block ``blk``
    is a contiguous run of cell indices, i.e. (in the column-major
    triangular enumeration) the cells from (x_lo, y_lo) through
    (x_hi, y_hi) inclusive: a prefix-cut first column, full middle
    columns, a suffix-cut last column. This is the O(1)-per-block
    description the tile-catalog executor compiles to corner-cut masks —
    no per-pair materialization. Only blocks with a non-empty segment are
    returned; coordinates are block-local.
    """
    lo, hi = map(int, plan.bounds[k])
    if hi <= lo:
        return []
    sizes, offsets = plan.block_sizes, plan.offsets
    b_lo, _, _ = en.invert_pair_index(np.int64(lo), sizes, offsets)
    b_hi, _, _ = en.invert_pair_index(np.int64(hi - 1), sizes, offsets)
    out = []
    for blk in range(int(b_lo), int(b_hi) + 1):
        n = int(sizes[blk])
        npairs = int(plan.pair_counts[blk])
        if npairs == 0:
            continue
        qlo = max(lo - int(offsets[blk]), 0)
        qhi = min(hi - int(offsets[blk]), npairs) - 1
        if qhi < qlo:
            continue
        x_lo, y_lo = (int(v) for v in en.invert_cell_index(np.int64(qlo), n))
        x_hi, y_hi = (int(v) for v in en.invert_cell_index(np.int64(qhi), n))
        out.append((blk, x_lo, y_lo, x_hi, y_hi))
    return out


def range_block_intervals(plan: PairRangePlan, k: int) -> List[Tuple[int, List[Tuple[int, int]]]]:
    """Per-block gather intervals (<= 2 each) for range k.

    Returns [(block, [(row_lo, row_hi_inclusive), ...]), ...] in blocked-
    layout rows. Proof sketch of the <=2 bound: within one block a
    contiguous pair-index interval covers columns x_lo..x_hi; if it spans
    >= 3 columns, some middle column is complete, whose y-values reach
    N-1, collapsing the union to a single interval [x_lo, N-1]; otherwise
    the union is [x_lo, ...] plus at most one y-tail.
    """
    sizes, estart = plan.block_sizes, plan.estart
    out = []
    for blk, x_lo, y_lo, x_hi, y_hi in range_block_segments(plan, k):
        n = int(sizes[blk])
        if x_hi >= x_lo + 2:
            ivs = [(x_lo, n - 1)]
        elif x_hi == x_lo:
            if y_lo == x_lo + 1:
                ivs = [(x_lo, y_hi)]
            else:
                ivs = [(x_lo, x_lo), (y_lo, y_hi)]
        else:  # x_hi == x_lo + 1
            first = (x_lo, y_hi)          # [x_lo, x_lo+1] ∪ [x_hi+1, y_hi]
            second = (y_lo, n - 1)        # y-tail of the partial first column
            if second[0] <= first[1] + 1:
                ivs = [(x_lo, n - 1)]
            else:
                ivs = [first, second]
        base = int(estart[blk])
        out.append((blk, [(base + a, base + b) for a, b in ivs]))
    return out


def entity_range_matrix(plan: PairRangePlan, max_pairs: int = 50_000_000) -> np.ndarray:
    """Exact (n_entities, r) bool membership — which ranges each entity is
    sent to (the union Alg. 2 computes map-side). Brute-force over all
    pairs, chunked; intended for DS1-scale benchmarks/tests."""
    if plan.total_pairs > max_pairs:
        raise ValueError(f"{plan.total_pairs} pairs exceeds brute-force budget")
    n = int(plan.block_sizes.sum())
    mask = np.zeros((n, plan.r), bool)
    per = -(-plan.total_pairs // plan.r) if plan.total_pairs else 1
    chunk = 4_000_000
    for lo in range(0, plan.total_pairs, chunk):
        p = np.arange(lo, min(lo + chunk, plan.total_pairs), dtype=np.int64)
        blk, x, y = en.invert_pair_index(p, plan.block_sizes, plan.offsets)
        rng = np.minimum(p // per, plan.r - 1)
        mask[plan.estart[blk] + x, rng] = True
        mask[plan.estart[blk] + y, rng] = True
    return mask


def map_output_size(plan: PairRangePlan) -> int:
    """kv-pairs emitted by map (Fig. 12): sum over entities of the number
    of relevant ranges, equivalently sum over ranges of the gather-set
    size. Closed form via the <=2-interval bound of
    :func:`range_block_intervals` — O(r + b) work, never O(P), so it is
    exact at any scale (DS2's 6.7·10⁹ pairs included).
    ``entity_range_matrix`` remains the brute-force oracle in tests."""
    total = 0
    for k in range(plan.r):
        for _, ivs in range_block_intervals(plan, k):
            total += sum(hi - lo + 1 for lo, hi in ivs)
    return total

"""Sorted Neighborhood blocking (Kolb/Thor/Rahm, arXiv:1010.3053).

The other canonical ER search-space reduction: entities are sorted by a
key and every pair within a sliding window of size ``w`` over the sort
order is compared — pair set {(i, j) : 0 < j − i ≤ w − 1} over sorted
positions, the *band* of width w − 1 above the diagonal. Unlike standard
blocking there is no block distribution to skew: the band's pair count is
a pure function of (n, w), so the paper's load-balancing discipline
reduces to an exact range partition of the band's pair-index space
(the PairRange treatment applied to the band instead of blocks).

Enumeration is row-major over the band: sorted row ``i`` holds
``c_i = min(w − 1, n − 1 − i)`` pairs ``(i, i+1) .. (i, i+c_i)``. The
first ``n − w_eff + 1`` rows are *full* (w_eff − 1 pairs each,
w_eff = min(w, n)); the tail rows shrink 1-per-row — exactly the
column-major triangular enumeration of a block of size w_eff − 1, so the
closed-form inverse reuses :func:`core.enumeration.invert_cell_index`.

Closed forms (w_eff = min(w, n), nf = n − w_eff + 1 full rows):

    P        = (w_eff − 1)·n − w_eff·(w_eff − 1)/2
    S(i)     = i·(w_eff − 1)                            for i ≤ nf
             = nf·(w_eff − 1) + Σ_{k=nf}^{i−1}(n−1−k)   otherwise
    p(i, j)  = S(i) + (j − i − 1)

Range k ∩ band is a contiguous run of band cells: rows i_lo..i_hi with a
prefix cut at (i_lo, j_lo) and a suffix cut at (i_hi, j_hi) — the same
corner-cut shape PairRange's range/block segments have, which is what the
tile-catalog compiler consumes (er/executor.py). The per-range *gather
set* (sorted rows a reducer must read) is a union of ≤ 2 contiguous
intervals, giving an O(r) exact ``map_output_size`` (Fig. 12 analog).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from . import enumeration as en

__all__ = [
    "SortedNeighborhoodPlan",
    "plan_sorted_neighborhood",
    "band_pair_count",
    "band_row_start",
    "band_pair_index",
    "invert_band_index",
    "pairs_of_band_range",
    "band_range_segment",
    "band_range_intervals",
    "map_output_size",
]


def _w_eff(n: int, w: int) -> int:
    """Effective window: w clamped to n (w ≥ n ⇒ the full triangle)."""
    return int(min(max(w, 1), max(n, 1)))


def band_pair_count(n: int, w: int) -> int:
    """|{(i, j) : 0 < j − i ≤ w − 1, 0 ≤ i < j < n}|."""
    we = _w_eff(n, w)
    if n < 2 or we < 2:
        return 0
    return (we - 1) * n - we * (we - 1) // 2


def band_row_start(i, n: int, w: int):
    """S(i): number of band pairs in sorted rows < i. Vectorized over i."""
    we = _w_eff(n, w)
    i = np.asarray(i, np.int64)
    nf = n - we + 1                      # rows 0..nf−1 are full (we−1 pairs)
    full = np.minimum(i, nf) * (we - 1)
    t = np.maximum(i - nf, 0)            # tail rows consumed
    # tail row nf+u holds we−2−u pairs: arithmetic series sum
    tail = t * (2 * (we - 2) - (t - 1)) // 2
    return full + tail


def band_pair_index(i, j, n: int, w: int):
    """Global band-pair index of (i, j), 0 < j − i ≤ w_eff − 1."""
    i = np.asarray(i, np.int64)
    j = np.asarray(j, np.int64)
    return band_row_start(i, n, w) + (j - i - 1)


def invert_band_index(p, n: int, w: int):
    """Inverse of :func:`band_pair_index`: p → (i, j). Vectorized over p.

    Full rows invert by divmod; tail rows are the triangular enumeration
    of a block of size w_eff − 1 shifted to start at row nf (docstring
    above), inverted with the exact :func:`enumeration.invert_cell_index`.
    """
    we = _w_eff(n, w)
    p = np.asarray(p, np.int64)
    nf = n - we + 1
    head = nf * (we - 1)
    in_full = p < head
    pc = np.where(in_full, p, 0)
    i_full = pc // max(we - 1, 1)
    j_full = i_full + 1 + pc % max(we - 1, 1)
    q = np.where(in_full, 0, p - head)
    x, y = en.invert_cell_index(q, np.int64(max(we - 1, 2)))
    return (np.where(in_full, i_full, nf + x),
            np.where(in_full, j_full, nf + y))


@dataclass(frozen=True)
class SortedNeighborhoodPlan:
    """Range partition of the window-w band over n sorted entities."""
    n: int
    w: int                     # requested window (w_eff = min(w, n) applies)
    r: int
    bounds: np.ndarray         # (r, 2) [lo, hi) band-pair-index bounds
    total_pairs: int

    @property
    def w_eff(self) -> int:
        return _w_eff(self.n, self.w)

    @property
    def reducer_pairs(self) -> np.ndarray:
        return (self.bounds[:, 1] - self.bounds[:, 0]).astype(np.int64)


def plan_sorted_neighborhood(n: int, w: int, r: int) -> SortedNeighborhoodPlan:
    """Balance the band over r reduce tasks: Alg. 2's ceil split of the
    pair-index space — exact by construction (max/mean ≤ ceil/floor)."""
    total = band_pair_count(n, w)
    return SortedNeighborhoodPlan(
        n=int(n), w=int(w), r=int(r),
        bounds=en.range_bounds(total, r), total_pairs=total)


def pairs_of_band_range(plan: SortedNeighborhoodPlan, k: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Materialize range k's pairs as (rows_a, rows_b) sorted positions."""
    lo, hi = map(int, plan.bounds[k])
    p = np.arange(lo, hi, dtype=np.int64)
    return invert_band_index(p, plan.n, plan.w)


def band_range_segment(plan: SortedNeighborhoodPlan, k: int
                       ) -> Tuple[int, int, int, int] | None:
    """Range k as a corner-cut band segment (i_lo, j_lo, i_hi, j_hi):
    rows i_lo..i_hi of the band, prefix-cut before (i_lo, j_lo), suffix-cut
    after (i_hi, j_hi). None if the range is empty."""
    lo, hi = map(int, plan.bounds[k])
    if hi <= lo:
        return None
    i_lo, j_lo = (int(v) for v in invert_band_index(np.int64(lo), plan.n, plan.w))
    i_hi, j_hi = (int(v) for v in invert_band_index(np.int64(hi - 1), plan.n, plan.w))
    return i_lo, j_lo, i_hi, j_hi


def band_range_intervals(plan: SortedNeighborhoodPlan, k: int
                         ) -> List[Tuple[int, int]]:
    """Gather set of range k — the sorted rows appearing in any of its
    pairs — as ≤ 2 disjoint [lo, hi]-inclusive intervals.

    Rows i_lo..i_hi are all present; columns of every row past the first
    start at i+1 ≤ i_hi+1, so rows ∪ those columns is one contiguous
    interval; only the first row's prefix-cut columns [j_lo, …] can
    detach (range starts deep inside row i_lo).
    """
    seg = band_range_segment(plan, k)
    if seg is None:
        return []
    i_lo, j_lo, i_hi, j_hi = seg
    n, we = plan.n, plan.w_eff
    if i_lo == i_hi:
        if j_lo <= i_lo + 1:
            return [(i_lo, j_hi)]
        return [(i_lo, i_lo), (j_lo, j_hi)]
    # columns of rows i_lo+1..i_hi: [i_lo+2, e_mid] ∪ [i_hi+1, j_hi] —
    # contiguous with the row interval [i_lo, i_hi].
    e_mid = min(i_hi - 1 + we - 1, n - 1) if i_hi > i_lo + 1 else i_hi
    base_hi = max(i_hi, e_mid, j_hi)
    e_first = min(i_lo + we - 1, n - 1)   # first row's columns [j_lo, e_first]
    if j_lo <= base_hi + 1:
        return [(i_lo, max(base_hi, e_first))]
    return [(i_lo, base_hi), (j_lo, e_first)]


def map_output_size(plan: SortedNeighborhoodPlan) -> int:
    """kv-pairs emitted by map (Fig. 12 analog): Σ over ranges of the
    gather-set size — O(r) via the ≤ 2-interval bound, exact at any scale."""
    total = 0
    for k in range(plan.r):
        for lo, hi in band_range_intervals(plan, k):
            total += hi - lo + 1
    return total

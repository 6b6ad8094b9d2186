"""Two-source matching R × S (paper Appendix I).

Per block k only cross-source pairs (e_R, e_S) are compared; the cell
enumeration becomes row-major rectangular: c(x, y, N_S) = x*N_S + y, with
o(i) = sum_{k<i} |Φ_k,R|*|Φ_k,S| (the paper prints a stray "-1"; dropping it
matches Fig. 15(b)). BlockSplit restricts cross tasks to Π_i ∈ R, Π_j ∈ S.

Entities without blocking keys (paper §III / App. I preamble) are handled by
the decomposition match_B(R,S) = match_B(R-R0, S-S0) ∪ match_⊥(R, S0) ∪
match_⊥(R0, S-S0) — implemented in er/pipeline.py by synthesizing a
constant blocking key for the ⊥ jobs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from . import enumeration as en
from .assignment import greedy_lpt

__all__ = [
    "TwoSourceBDM",
    "BlockSplit2Plan",
    "PairRange2Plan",
    "plan_block_split_2src",
    "plan_pair_range_2src",
    "pairs_of_range_2src",
    "range_block_segments_2src",
]


@dataclass(frozen=True)
class TwoSourceBDM:
    """Per-source BDMs over a shared dense block-index space."""
    bdm_r: np.ndarray  # (b, m_r)
    bdm_s: np.ndarray  # (b, m_s)

    @property
    def sizes_r(self) -> np.ndarray:
        return self.bdm_r.sum(axis=1).astype(np.int64)

    @property
    def sizes_s(self) -> np.ndarray:
        return self.bdm_s.sum(axis=1).astype(np.int64)


@dataclass(frozen=True)
class BlockSplit2Plan:
    r: int
    task_block: np.ndarray
    task_i: np.ndarray           # partition in R (-1: unsplit)
    task_j: np.ndarray           # partition in S (-1: unsplit)
    task_pairs: np.ndarray
    task_reducer: np.ndarray
    reducer_pairs: np.ndarray
    # Geometry: row intervals in the per-source blocked layouts.
    task_a_start: np.ndarray     # rows in R layout
    task_a_len: np.ndarray
    task_b_start: np.ndarray     # rows in S layout
    task_b_len: np.ndarray
    total_pairs: int
    n_rows_r: int = 0            # total rows in the R blocked layout
    n_rows_s: int = 0            # total rows in the S blocked layout


def plan_block_split_2src(bdm2: TwoSourceBDM, r: int) -> BlockSplit2Plan:
    br, bs = np.asarray(bdm2.bdm_r, np.int64), np.asarray(bdm2.bdm_s, np.int64)
    b, m_r = br.shape
    _, m_s = bs.shape
    sr, ss = br.sum(axis=1), bs.sum(axis=1)
    pairs = sr * ss
    total = int(pairs.sum())
    avg = total / r if r else 0.0

    er_start = np.concatenate([np.zeros(1, np.int64), np.cumsum(sr)[:-1]])
    es_start = np.concatenate([np.zeros(1, np.int64), np.cumsum(ss)[:-1]])
    sub_r = np.concatenate([np.zeros((b, 1), np.int64), np.cumsum(br, axis=1)[:, :-1]], axis=1)
    sub_s = np.concatenate([np.zeros((b, 1), np.int64), np.cumsum(bs, axis=1)[:, :-1]], axis=1)

    t_block, t_i, t_j, t_pairs = [], [], [], []
    a0, al, b0, bl = [], [], [], []
    for k in range(b):
        if pairs[k] == 0:
            continue
        if pairs[k] <= avg:
            t_block.append(k); t_i.append(-1); t_j.append(-1)
            t_pairs.append(int(pairs[k]))
            a0.append(int(er_start[k])); al.append(int(sr[k]))
            b0.append(int(es_start[k])); bl.append(int(ss[k]))
        else:
            for i in range(m_r):
                ni = int(br[k, i])
                if ni == 0:
                    continue
                for j in range(m_s):
                    nj = int(bs[k, j])
                    if nj == 0:
                        continue
                    t_block.append(k); t_i.append(i); t_j.append(j)
                    t_pairs.append(ni * nj)
                    a0.append(int(er_start[k] + sub_r[k, i])); al.append(ni)
                    b0.append(int(es_start[k] + sub_s[k, j])); bl.append(nj)

    w = np.asarray(t_pairs, np.int64)
    assignment, loads = greedy_lpt(w, r)
    return BlockSplit2Plan(
        r=r,
        task_block=np.asarray(t_block, np.int64),
        task_i=np.asarray(t_i, np.int64),
        task_j=np.asarray(t_j, np.int64),
        task_pairs=w, task_reducer=assignment, reducer_pairs=loads,
        task_a_start=np.asarray(a0, np.int64), task_a_len=np.asarray(al, np.int64),
        task_b_start=np.asarray(b0, np.int64), task_b_len=np.asarray(bl, np.int64),
        total_pairs=total, n_rows_r=int(sr.sum()), n_rows_s=int(ss.sum()))


@dataclass(frozen=True)
class PairRange2Plan:
    r: int
    sizes_r: np.ndarray
    sizes_s: np.ndarray
    pair_counts: np.ndarray
    offsets: np.ndarray
    er_start: np.ndarray
    es_start: np.ndarray
    bounds: np.ndarray
    total_pairs: int

    @property
    def reducer_pairs(self) -> np.ndarray:
        return (self.bounds[:, 1] - self.bounds[:, 0]).astype(np.int64)

    @property
    def n_rows_r(self) -> int:
        return int(self.sizes_r.sum())

    @property
    def n_rows_s(self) -> int:
        return int(self.sizes_s.sum())


def plan_pair_range_2src(bdm2: TwoSourceBDM, r: int) -> PairRange2Plan:
    sr, ss = bdm2.sizes_r, bdm2.sizes_s
    pairs = en.block_pair_counts_2src(sr, ss)
    offsets, total = en.pair_offsets(pairs)
    er_start = np.concatenate([np.zeros(1, np.int64), np.cumsum(sr)[:-1]])
    es_start = np.concatenate([np.zeros(1, np.int64), np.cumsum(ss)[:-1]])
    return PairRange2Plan(
        r=r, sizes_r=sr, sizes_s=ss, pair_counts=pairs, offsets=offsets,
        er_start=er_start, es_start=es_start,
        bounds=en.range_bounds(total, r), total_pairs=total)


def pairs_of_range_2src(plan: PairRange2Plan, k: int):
    """Materialize range k's pairs: (block, x, y, row_r, row_s)."""
    lo, hi = plan.bounds[k]
    p = np.arange(lo, hi, dtype=np.int64)
    block = np.searchsorted(plan.offsets, p, side="right") - 1
    q = p - plan.offsets[block]
    x, y = en.invert_cell_index_2src(q, plan.sizes_s[block])
    return block, x, y, plan.er_start[block] + x, plan.es_start[block] + y


def range_block_segments_2src(plan: PairRange2Plan,
                              k: int) -> List[Tuple[int, int, int, int, int]]:
    """Per-block cell segments of range k: [(block, x_lo, y_lo, x_hi, y_hi)].

    Range k's pair-index interval [lo, hi) intersected with block ``blk``
    is a contiguous run of the row-major rectangular enumeration
    ``c(x, y) = x·N_S + y``: a prefix-cut first row, full middle rows, a
    suffix-cut last row — the rectangular analog of
    ``pair_range.range_block_segments``, and exactly what the tile-catalog
    compiler turns into lb/ub corner-cut predicates. O(1) per (range,
    block); only non-empty segments are returned, coordinates block-local.
    """
    lo, hi = map(int, plan.bounds[k])
    if hi <= lo:
        return []
    offsets, counts = plan.offsets, plan.pair_counts
    b_lo = int(np.searchsorted(offsets, lo, side="right")) - 1
    b_hi = int(np.searchsorted(offsets, hi - 1, side="right")) - 1
    out = []
    for blk in range(b_lo, b_hi + 1):
        npairs = int(counts[blk])
        if npairs == 0:
            continue
        qlo = max(lo - int(offsets[blk]), 0)
        qhi = min(hi - int(offsets[blk]), npairs) - 1
        if qhi < qlo:
            continue
        ns = int(plan.sizes_s[blk])
        out.append((blk, qlo // ns, qlo % ns, qhi // ns, qhi % ns))
    return out

"""BlockSplit (paper §IV, Alg. 1).

Blocks whose pair count exceeds the average reducer workload P/r are split
along the m input partitions into sub-blocks; a split block k yields
  * m single-sub-block match tasks  k.i      (triangular work), and
  * m(m-1)/2 cross tasks            k.i×j    (rectangular work),
which together cover exactly the block's pair set. Tasks are assigned to
reduce tasks greedy-LPT (largest first). Entities of split blocks are
replicated once per non-empty partition of their block (paper footnote 3).

TPU mapping: our canonical *blocked layout* (core/bdm.blocked_layout) orders
each block's entities partition-major, so every sub-block is a contiguous
row interval. A match task therefore compiles to a static geometry record

    (a_start, a_len, b_start, b_len, triangular)

— a triangular tile for k.i / unsplit blocks (a == b) or a rectangular tile
for k.i×j — which is exactly what the pair-similarity kernel consumes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import enumeration as en
from .assignment import greedy_lpt

__all__ = ["BlockSplitPlan", "plan_block_split"]


@dataclass(frozen=True)
class BlockSplitPlan:
    r: int
    m: int
    bdm: np.ndarray              # (b, m)
    block_sizes: np.ndarray      # (b,)
    split_mask: np.ndarray       # (b,) bool — block was split
    # Match-task table (t tasks):
    task_block: np.ndarray       # (t,)
    task_i: np.ndarray           # (t,)  -1 for unsplit whole-block tasks
    task_j: np.ndarray           # (t,)  -1 for unsplit; j <= i for cross
    task_pairs: np.ndarray       # (t,)
    task_reducer: np.ndarray     # (t,)
    reducer_pairs: np.ndarray    # (r,)
    # Tile geometry in the blocked layout:
    task_a_start: np.ndarray     # (t,)
    task_a_len: np.ndarray       # (t,)
    task_b_start: np.ndarray     # (t,)
    task_b_len: np.ndarray       # (t,)
    task_triangular: np.ndarray  # (t,) bool
    total_pairs: int

    def map_output_size(self) -> int:
        """kv-pairs emitted by map (Fig. 12): 1 per entity of an unsplit
        block with >=1 pair, (#non-empty partitions) per entity of a split
        block. Entities of singleton blocks are dropped (no pairs)."""
        sizes = self.block_sizes
        nonempty = (self.bdm > 0).sum(axis=1)
        unsplit = (~self.split_mask) & (sizes > 1)
        return int(sizes[unsplit].sum()
                   + (sizes[self.split_mask] * nonempty[self.split_mask]).sum())


def plan_block_split(bdm: np.ndarray, r: int) -> BlockSplitPlan:
    bdm = np.asarray(bdm, np.int64)
    b, m = bdm.shape
    sizes = bdm.sum(axis=1)
    pairs = en.block_pair_counts(sizes)
    total = int(pairs.sum())
    avg = total / r if r else 0.0

    split_mask = pairs > avg  # paper: strict '>' (Alg. 1 line 10 is '<=')

    estart = np.concatenate([np.zeros(1, np.int64), np.cumsum(sizes)[:-1]])
    sub_off = np.concatenate(
        [np.zeros((b, 1), np.int64), np.cumsum(bdm, axis=1)[:, :-1]], axis=1)

    t_block, t_i, t_j, t_pairs = [], [], [], []
    a_start, a_len, b_start, b_len, tri = [], [], [], [], []

    # Unsplit blocks with at least one pair: one triangular task each.
    for k in np.flatnonzero((~split_mask) & (pairs > 0)):
        t_block.append(k); t_i.append(-1); t_j.append(-1)
        t_pairs.append(int(pairs[k]))
        a_start.append(int(estart[k])); a_len.append(int(sizes[k]))
        b_start.append(int(estart[k])); b_len.append(int(sizes[k]))
        tri.append(True)

    # Split blocks: k.i (triangular) and k.i×j, i > j (rectangular).
    for k in np.flatnonzero(split_mask):
        for i in range(m):
            ni = int(bdm[k, i])
            if ni == 0:
                continue
            # Alg. 1 line 16 keeps k.i even for singleton sub-blocks
            # (0 pairs) — the entity is still routed to it.
            t_block.append(k); t_i.append(i); t_j.append(i)
            t_pairs.append(ni * (ni - 1) // 2)
            s = int(estart[k] + sub_off[k, i])
            a_start.append(s); a_len.append(ni)
            b_start.append(s); b_len.append(ni)
            tri.append(True)
            for j in range(i):
                nj = int(bdm[k, j])
                if nj == 0:
                    continue
                t_block.append(k); t_i.append(i); t_j.append(j)
                t_pairs.append(ni * nj)
                a_start.append(int(estart[k] + sub_off[k, i])); a_len.append(ni)
                b_start.append(int(estart[k] + sub_off[k, j])); b_len.append(nj)
                tri.append(False)

    task_pairs = np.asarray(t_pairs, np.int64)
    assignment, loads = greedy_lpt(task_pairs, r)

    return BlockSplitPlan(
        r=r, m=m, bdm=bdm,
        block_sizes=sizes, split_mask=split_mask,
        task_block=np.asarray(t_block, np.int64),
        task_i=np.asarray(t_i, np.int64),
        task_j=np.asarray(t_j, np.int64),
        task_pairs=task_pairs,
        task_reducer=assignment,
        reducer_pairs=loads,
        task_a_start=np.asarray(a_start, np.int64),
        task_a_len=np.asarray(a_len, np.int64),
        task_b_start=np.asarray(b_start, np.int64),
        task_b_len=np.asarray(b_len, np.int64),
        task_triangular=np.asarray(tri, bool),
        total_pairs=total,
    )

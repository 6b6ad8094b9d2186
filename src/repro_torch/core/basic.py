"""The Basic strategy (paper §III): key-partitioned blocks, no skew handling.

Every block goes in full to one reduce task, chosen by hashing the blocking
key (Hadoop's default HashPartitioner ≡ ``block_index mod r`` once keys are
dense indices). This is the paper's baseline and the one that collapses on
skew: the largest block's pair count lower-bounds the makespan.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import enumeration as en

__all__ = ["BasicPlan", "plan_basic"]


@dataclass(frozen=True)
class BasicPlan:
    """block -> reduce task, plus per-reducer pair loads."""
    r: int
    block_sizes: np.ndarray      # (b,)
    block_reducer: np.ndarray    # (b,)
    reducer_pairs: np.ndarray    # (r,)
    total_pairs: int

    # Every entity is emitted exactly once (no replication) — Fig. 12.
    def map_output_size(self) -> int:
        return int(self.block_sizes.sum())


def plan_basic(bdm: np.ndarray, r: int, salt: int = 0) -> BasicPlan:
    sizes = bdm.sum(axis=1).astype(np.int64)
    pairs = en.block_pair_counts(sizes)
    # Dense block indices stand in for key hashes; `salt` lets benchmarks
    # explore hash-placement luck (the Fig. 10 peaks).
    reducer = (np.arange(sizes.shape[0], dtype=np.int64) + salt) % r
    loads = np.bincount(reducer, weights=pairs, minlength=r).astype(np.int64)
    return BasicPlan(
        r=r,
        block_sizes=sizes,
        block_reducer=reducer,
        reducer_pairs=loads,
        total_pairs=int(pairs.sum()),
    )

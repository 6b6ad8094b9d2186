"""Block Distribution Matrix (paper §III-B, Alg. 3).

Job 1 of the paper's workflow: count entities per (block, input partition).
The BDM is tiny (b × m int64) and is the *only* state the load-balancing
strategies need — BlockSplit's match-task table and PairRange's ranges are
deterministic functions of it, which is also the fault-tolerance story: a
restarted worker recomputes its plan from the checkpointed BDM.

Two implementations, as ``repro.core.bdm``:
  * :func:`compute_bdm` / :func:`entity_indices` — numpy, host-side
    (planning path).
  * :func:`compute_bdm_torch` / :func:`entity_indices_torch` — torch on
    any device, static shapes (the reference's ``*_jnp`` twins, with
    ``torch.cummax`` for ``lax.cummax``).

Entity indexing (paper §V, Fig. 6 "white numbers"): entity e in partition
Π_i, block Φ_k gets global index = (# entities of Φ_k in Π_0..Π_{i-1}) +
(rank of e among Φ_k-entities within Π_i, in input order). This is the
paper's map-side local enumeration enabled by the BDM.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "compute_bdm",
    "compute_bdm_torch",
    "update_bdm",
    "entity_indices",
    "entity_indices_torch",
    "blocked_layout",
]


def compute_bdm(block_ids: np.ndarray, partition_ids: np.ndarray,
                num_blocks: int, num_partitions: int) -> np.ndarray:
    """BDM[k, i] = |{e : block(e)=k, partition(e)=i}| (b × m int64)."""
    flat = np.asarray(block_ids, np.int64) * num_partitions + np.asarray(partition_ids, np.int64)
    counts = np.bincount(flat, minlength=num_blocks * num_partitions)
    return counts.reshape(num_blocks, num_partitions).astype(np.int64)


def compute_bdm_torch(block_ids: torch.Tensor, partition_ids: torch.Tensor,
                      num_blocks: int, num_partitions: int) -> torch.Tensor:
    """Torch twin of :func:`compute_bdm` (static b, m): the (b, m) counts
    as int64 on the device of ``block_ids``. A scatter-add, not
    ``bincount``, so no length is read back to the host."""
    flat = (block_ids.to(torch.int64) * num_partitions
            + partition_ids.to(torch.int64))
    counts = torch.zeros(num_blocks * num_partitions, dtype=torch.int64,
                         device=block_ids.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    return counts.reshape(num_blocks, num_partitions)


def update_bdm(bdm: np.ndarray, block_ids: np.ndarray,
               partition_ids: np.ndarray,
               num_blocks: int | None = None) -> np.ndarray:
    """Incremental Job 1: fold a new entity batch into an existing BDM.

    Because the BDM is a pure per-(block, partition) count, it is a monoid
    under elementwise addition — ``update_bdm(compute_bdm(A), B) ==
    compute_bdm(A ++ B)`` for any split, which is what lets a resident
    service absorb query micro-batches without replanning Job 1 from
    scratch. Never-seen blocks grow the matrix by appending zero rows
    (block ids must stay dense); ``num_blocks`` forces growth to at least
    that many rows even when the batch is empty. The partition count is
    pinned to ``bdm.shape[1]``. Returns a new (b', m) int64 matrix with
    b' >= bdm.shape[0]; the input is never mutated.
    """
    bdm = np.asarray(bdm, np.int64)
    b, m = bdm.shape
    block_ids = np.asarray(block_ids, np.int64)
    partition_ids = np.asarray(partition_ids, np.int64)
    nb = max(b, num_blocks or 0,
             int(block_ids.max()) + 1 if block_ids.size else 0)
    out = np.zeros((nb, m), np.int64)
    out[:b] = bdm
    if block_ids.size:
        out += compute_bdm(block_ids, partition_ids, nb, m)
    return out


def _cumcount_by_key(key: np.ndarray) -> np.ndarray:
    """rank[e] = #{e' < e (input order) : key[e'] == key[e]} — vectorized."""
    n = key.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(key, kind="stable")  # groups keys, preserves input order
    sorted_key = key[order]
    new_group = np.empty(n, bool)
    new_group[0] = True
    np.not_equal(sorted_key[1:], sorted_key[:-1], out=new_group[1:])
    group_start = np.maximum.accumulate(np.where(new_group, np.arange(n), 0))
    rank_sorted = np.arange(n) - group_start
    rank = np.empty(n, np.int64)
    rank[order] = rank_sorted
    return rank


def entity_indices(block_ids: np.ndarray, partition_ids: np.ndarray,
                   bdm: np.ndarray) -> np.ndarray:
    """Global per-block entity index x for every entity (paper Fig. 6)."""
    b, m = bdm.shape
    block_ids = np.asarray(block_ids, np.int64)
    partition_ids = np.asarray(partition_ids, np.int64)
    # offset[k, i] = # entities of block k in partitions < i  (exclusive cumsum)
    offs = np.concatenate([np.zeros((b, 1), np.int64), np.cumsum(bdm, axis=1)[:, :-1]], axis=1)
    base = offs[block_ids, partition_ids]
    rank = _cumcount_by_key(block_ids * m + partition_ids)
    return base + rank


def entity_indices_torch(block_ids: torch.Tensor,
                         partition_ids: torch.Tensor,
                         bdm: torch.Tensor) -> torch.Tensor:
    """Torch twin of :func:`entity_indices` (int64, on the device of
    ``block_ids``): the exclusive per-block offset of each partition plus
    the entity's rank among its (block, partition) group in input order,
    the group starts carried forward by ``torch.cummax``."""
    b, m = bdm.shape
    n = block_ids.shape[0]
    dev = block_ids.device
    block_ids = block_ids.to(torch.int64)
    partition_ids = partition_ids.to(torch.int64)
    bdm = bdm.to(torch.int64)
    offs = torch.cat([torch.zeros((b, 1), dtype=torch.int64, device=dev),
                      torch.cumsum(bdm, dim=1)[:, :-1]], dim=1)
    base = offs[block_ids, partition_ids]
    key = block_ids * m + partition_ids
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    new_group = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           sorted_key[1:] != sorted_key[:-1]])[:n]
    group_start = torch.cummax(torch.where(new_group, iota, 0), dim=0).values
    rank = torch.empty_like(iota)
    rank[order] = iota - group_start
    return base + rank


def blocked_layout(block_ids: np.ndarray, entity_idx: np.ndarray,
                   block_sizes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Permutation into the canonical blocked layout.

    Row ``estart[k] + x`` holds the entity with (block k, index x), where
    ``estart`` is the exclusive cumsum of block sizes. Returns
    ``(perm, estart)`` with ``perm[target_row] = source_row``.
    """
    sizes = np.asarray(block_sizes, np.int64)
    estart = np.concatenate([np.zeros(1, np.int64), np.cumsum(sizes)[:-1]])
    target = estart[np.asarray(block_ids, np.int64)] + np.asarray(entity_idx, np.int64)
    perm = np.empty(target.shape[0], np.int64)
    perm[target] = np.arange(target.shape[0])
    return perm, estart

"""Blocking-key generation (paper §I, §VI).

The paper's default key is the first three letters of the title; the
robustness study (Fig. 9) replaces it with a controlled exponential block
distribution ``|Φ_k| ∝ e^{−s·k}`` over b=100 blocks. Both are provided.
Entities without a usable key get block id −1 (handled by the pipeline's
match_⊥ decomposition, paper §III / Appendix I).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["prefix_key", "prefix_block_ids", "dense_block_ids",
           "exponential_block_ids", "exponential_block_sizes",
           "sn_sort_keys", "sn_sort_order"]


def prefix_key(title: str, k: int = 3) -> str | None:
    """The paper's blocking key for one entity: first k letters of the
    normalized title, or None when no key can be formed (→ block −1,
    the match_⊥ decomposition). THE single definition of the key rule —
    the batch pipeline and the resident service must derive identical
    keys or the streaming ≡ batch contract breaks."""
    key = title.strip().lower()[:k]
    return key if key else None


def prefix_block_ids(titles: Sequence[str], k: int = 3) -> Tuple[np.ndarray, List[str]]:
    """First-k-letters blocking. Returns (block_ids int64 with −1 for
    entities lacking a key, list of key strings by block id).

    Block ids are assigned in first-occurrence order — the paper's
    "(arbitrary) order of the blocks from the reduce output" (§III-B).
    """
    ids = np.empty(len(titles), np.int64)
    keys: dict[str, int] = {}
    names: List[str] = []
    for i, t in enumerate(titles):
        key = prefix_key(t, k)
        if key is None:
            ids[i] = -1
            continue
        if key not in keys:
            keys[key] = len(names)
            names.append(key)
        ids[i] = keys[key]
    return ids, names


def sn_sort_keys(titles: Sequence[str]) -> List[str]:
    """Sorted-Neighborhood sort keys (arXiv:1010.3053): the normalized
    title itself — the lexicographic analog of the prefix blocking key,
    but *total*: every entity gets a key (empty titles sort first), so SN
    has no match_⊥ decomposition."""
    return [t.strip().lower() for t in titles]


def sn_sort_order(titles: Sequence[str]) -> np.ndarray:
    """Stable argsort of :func:`sn_sort_keys` — the SN sort pass (the
    MR-implementation's Job 1). Returns int64 positions: ``order[p]`` is
    the original index of the entity at sorted position ``p``."""
    return np.argsort(np.asarray(sn_sort_keys(titles)),
                      kind="stable").astype(np.int64)


def dense_block_ids(keys: Sequence) -> Tuple[np.ndarray, list]:
    """Factorize arbitrary hashable keys into dense [0, b) ids."""
    ids = np.empty(len(keys), np.int64)
    seen: dict = {}
    names: list = []
    for i, key in enumerate(keys):
        if key not in seen:
            seen[key] = len(names)
            names.append(key)
        ids[i] = seen[key]
    return ids, names


def exponential_block_sizes(n_entities: int, b: int, s: float) -> np.ndarray:
    """Block sizes ∝ e^{−s·k}, k=0..b−1, summing to n_entities (Fig. 9).

    Largest-remainder rounding keeps the total exact; every block keeps at
    least one entity where possible.
    """
    w = np.exp(-s * np.arange(b, dtype=np.float64))
    ideal = w / w.sum() * n_entities
    sizes = np.floor(ideal).astype(np.int64)
    rem = n_entities - int(sizes.sum())
    frac_order = np.argsort(-(ideal - sizes), kind="stable")
    sizes[frac_order[:rem]] += 1
    return sizes


def exponential_block_ids(n_entities: int, b: int, s: float,
                          rng: np.random.Generator | None = None) -> np.ndarray:
    """Assign entities to blocks with the Fig. 9 exponential skew; the
    assignment is shuffled so input partitions mix blocks (the unsorted
    regime of Fig. 11)."""
    sizes = exponential_block_sizes(n_entities, b, s)
    ids = np.repeat(np.arange(b, dtype=np.int64), sizes)
    if rng is not None:
        rng.shuffle(ids)
    return ids

"""Pair enumeration for PairRange (paper §V, Appendix I).

The paper enumerates, per block ``Φ_i`` of size ``N``, all unordered pairs
``(x, y)`` with ``x < y`` in *column-major* order:

    c(x, y, N) = x/2 * (2N - x - 3) + y - 1            (one source)
    c(x, y, N) = x * N + y                             (two sources, |Φ_S|=N)

and offsets the per-block index by the number of pairs in preceding blocks:

    o(i) = 1/2 * sum_{k<i} |Φ_k| (|Φ_k| - 1)           (one source)
    o(i) = sum_{k<i} |Φ_k,R| * |Φ_k,S|                 (two sources)

(The paper's Appendix I prints ``o(i) = Σ... - 1``; with that constant the
very first pair would get index -1, contradicting Fig. 15(b). We drop the
spurious ``-1`` — a typo in the paper.)

This module provides the forward maps exactly as in the paper plus the
**closed-form inverses** ``p -> (block, x, y)``: a worker owning pair
range ``[lo, hi)`` materializes its pair list with a vectorized inverse
instead of Hadoop's group-iterator.

A numpy copy of ``repro.core.enumeration``: all functions are pure and
work on numpy int64 arrays (host planning).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "cell_index",
    "cell_index_2src",
    "column_start",
    "column_of_cell",
    "invert_cell_index",
    "invert_cell_index_2src",
    "block_pair_counts",
    "block_pair_counts_2src",
    "pair_offsets",
    "pair_index",
    "invert_pair_index",
    "range_of_pair",
    "range_bounds",
]


# ---------------------------------------------------------------------------
# Per-block cell enumeration (paper eq. (1))
# ---------------------------------------------------------------------------

def cell_index(x, y, n):
    """Paper's ``c(x, y, N)``: index of pair (x, y), x < y, in a block of
    size ``n`` under column-major upper-triangular enumeration."""
    return (x * (2 * n - x - 3)) // 2 + y - 1


def cell_index_2src(x, y, n_s):
    """Two-source ``c(x, y, N) = x*N + y`` (x indexes R, y indexes S)."""
    return x * n_s + y


def column_start(x, n):
    """Number of pairs in columns ``0..x-1`` = index of the first pair of
    column ``x``, i.e. ``c(x, x+1, n)``.  S(x) = x(2n - x - 1)/2."""
    return (x * (2 * n - x - 1)) // 2


def column_of_cell(q, n):
    """Inverse of :func:`column_start`: the column ``x`` containing local
    cell index ``q`` (0 <= q < n(n-1)/2).

    Closed form via the triangular root, with a two-step Newton/boundary
    correction so it is exact for every representable integer input (the
    float estimate can be off by one near column boundaries).
    Works elementwise on arrays.
    """
    # Estimate from solving S(x) <= q:  x = floor(((2n-1) - sqrt((2n-1)^2 - 8q)) / 2)
    a = 2 * n - 1
    disc = a * a - 8 * q
    # Guard: q may equal the last valid index; disc >= 1 there.
    est = (a - np.sqrt(np.maximum(disc, 0).astype(np.float64))) / 2.0
    x = np.floor(est).astype(getattr(q, "dtype", np.int64))
    x = np.clip(x, 0, np.maximum(n - 2, 0))
    # Boundary corrections (two passes cover float error of +/-1 each way).
    for _ in range(2):
        x = np.where(column_start(x, n) > q, x - 1, x)
        x = np.where(column_start(x + 1, n) <= q, x + 1, x)
    return np.clip(x, 0, np.maximum(n - 2, 0))


def invert_cell_index(q, n):
    """Inverse of :func:`cell_index`: local cell ``q`` -> (x, y)."""
    x = column_of_cell(q, n)
    y = q - column_start(x, n) + x + 1
    return x, y


def invert_cell_index_2src(q, n_s):
    """Inverse of :func:`cell_index_2src`: ``q -> (x, y)``."""
    return q // n_s, q % n_s


# ---------------------------------------------------------------------------
# Cross-block offsets (paper's o(i)) and global pair indexing
# ---------------------------------------------------------------------------

def block_pair_counts(sizes):
    """Pairs per block: |Φ|(|Φ|-1)/2. ``sizes`` int array (b,)."""
    s = sizes.astype(np.int64) if hasattr(sizes, "astype") else np.asarray(sizes, np.int64)
    return (s * (s - 1)) // 2


def block_pair_counts_2src(sizes_r, sizes_s):
    """Pairs per block for two sources: |Φ_R| * |Φ_S|."""
    r = np.asarray(sizes_r, np.int64)
    s = np.asarray(sizes_s, np.int64)
    return r * s


def pair_offsets(pair_counts):
    """o(i) for every block, plus total P: exclusive cumsum.

    Returns ``(offsets, total)`` with ``offsets.shape == pair_counts.shape``.
    """
    counts = np.asarray(pair_counts, np.int64)
    csum = np.cumsum(counts)
    total = int(csum[-1]) if counts.size else 0
    offsets = np.concatenate([np.zeros(1, np.int64), csum[:-1]])
    return offsets, total


def pair_index(block, x, y, sizes, offsets):
    """Global pair index p_i(x, y) (paper eq. (1)), vectorized."""
    n = sizes[block]
    return offsets[block] + cell_index(x, y, n)


def invert_pair_index(p, sizes, offsets):
    """Global pair index -> (block, x, y). Vectorized over ``p``.

    ``offsets`` must be the exclusive-cumsum from :func:`pair_offsets` and
    ``sizes`` the per-block entity counts. Blocks with zero pairs occupy an
    empty interval and are never returned.
    """
    p = np.asarray(p)
    # block = rightmost i with offsets[i] <= p  (searchsorted on the right).
    block = np.searchsorted(offsets, p, side="right") - 1
    # Skip backwards over empty blocks (offsets repeat for 0-pair blocks):
    # searchsorted('right') already lands on the *last* block with that
    # offset only if it has pairs covering p; for ties, the last tied block
    # is correct because preceding tied blocks contribute zero pairs.
    q = p - offsets[block]
    x, y = invert_cell_index(q, sizes[block])
    return block, x, y


# ---------------------------------------------------------------------------
# Pair ranges (paper eq. (2) / Alg. 2's ceil scheme)
# ---------------------------------------------------------------------------

def range_of_pair(p, total, r):
    """Range (= reduce task) index of pair ``p``.

    We use Alg. 2's scheme: ``k = floor(p / ceil(P/r))`` — the first r-1
    ranges hold ``ceil(P/r)`` pairs, the last the remainder. (Eq. (2)'s
    ``floor(r*p/P)`` differs only in boundary placement; both are "almost
    equal" splits. Alg. 2 is what the paper implements.)
    """
    per = -(-total // r) if total else 1  # ceil(P/r), guard P=0
    return np.minimum(np.asarray(p) // per, r - 1)


def range_bounds(total, r):
    """``[lo, hi)`` pair-index bounds per range, shape (r, 2)."""
    per = -(-total // r) if total else 0
    lo = np.minimum(np.arange(r, dtype=np.int64) * per, total)
    hi = np.minimum(lo + per, total)
    return np.stack([lo, hi], axis=1)

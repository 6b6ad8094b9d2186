"""Shared inputs of the port's parity tests: dyadic and unit-row features,
random catalogs that exercise every predicate, and the skewed corpus of
tests/test_executor_parity.py with and without key-less titles."""
import numpy as np
import torch

from repro_torch.er import exponential_block_ids, make_products
from repro_torch.er.compiler.ir import NO_LB, NO_UB
from repro_torch.kernels.pair_sim import NCOLS

# The test files run side by side in several worker processes; one
# intra-op thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

SHAPES = [(64, 64, 32), (200, 130, 64), (128, 128, 256), (257, 31, 128)]
DTYPES = ["float32", "bfloat16"]


def dyadic(rng, n, d):
    return (rng.integers(-4, 5, (n, d)) / 8.0).astype(np.float32)


def unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def catalog(rng, m, n, bm, bn, t=24, pad=3, only=None):
    """Random entries exercising every predicate (window, tri, lb/ub
    corner cuts, band) over the strips of an (m, n) problem, plus ``pad``
    all-zero rows. ``only`` keeps a single predicate active."""
    ti = rng.integers(0, -(-m // bm), t)
    tj = rng.integers(0, -(-n // bn), t)
    cat = np.zeros((t, NCOLS), np.int64)
    cat[:, 0], cat[:, 1] = ti, tj
    cat[:, 2] = ti * bm + rng.integers(0, bm // 2, t)
    cat[:, 3] = np.minimum(cat[:, 2] + rng.integers(1, bm + 1, t), m)
    cat[:, 4] = tj * bn + rng.integers(0, bn // 2, t)
    cat[:, 5] = np.minimum(cat[:, 4] + rng.integers(1, bn + 1, t), n)
    cat[:, 6] = rng.integers(0, 2, t)
    cut = rng.random(t) < 0.5
    cat[:, 7] = np.where(cut, cat[:, 2] + rng.integers(0, bm, t), NO_LB)
    cat[:, 8] = np.where(cut, cat[:, 4] + rng.integers(0, bn, t), NO_LB)
    cut = rng.random(t) < 0.5
    cat[:, 9] = np.where(cut, cat[:, 2] + rng.integers(0, bm, t), NO_UB)
    cat[:, 10] = np.where(cut, cat[:, 4] + rng.integers(0, bn, t), NO_UB)
    cat[:, 11] = np.where(rng.random(t) < 0.5, rng.integers(1, 2 * bn, t), 0)
    if only is not None:
        keep = {"window": (), "tri": (6,), "lb": (7, 8), "ub": (9, 10),
                "band": (11,)}[only]
        for c in (6, 7, 8, 9, 10, 11):
            if c not in keep:
                cat[:, c] = {7: NO_LB, 8: NO_LB, 9: NO_UB, 10: NO_UB}.get(c, 0)
    cat = np.concatenate([cat, np.zeros((pad, NCOLS), np.int64)])
    return cat.astype(np.int32)


def assert_near_threshold_only(got, want, a, b, cat, bm, bn, thr):
    """Masks agree except on cells whose f64 score is within 1e-6 of thr."""
    diff = np.argwhere(got != want)
    for t, i, j in diff:
        s = np.dot(a[cat[t, 0] * bm + i].astype(np.float64),
                   b[cat[t, 1] * bn + j].astype(np.float64))
        assert abs(s - float(np.float32(thr))) <= 1e-6, (t, i, j, s)


def skewed_corpus():
    """tests/test_executor_parity.py's corpus: 1,200 titles blocked by the
    Fig. 9 s=1.0 skew. Returns (titles, block_ids)."""
    ds = make_products(1200, seed=11)
    bid = exponential_block_ids(ds.n, b=30, s=1.0,
                                rng=np.random.default_rng(11))
    return list(ds.titles), bid


def keyless(titles, bid):
    """Every 41st entity loses its blocking key (block id −1, title
    blank), so the match_⊥ cross job runs."""
    titles, bid = list(titles), bid.copy()
    for i in range(0, len(titles), 41):
        titles[i], bid[i] = "  ", -1
    return titles, bid

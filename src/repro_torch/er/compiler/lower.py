"""Lowering: MatchJob task rectangles → MXU-aligned tile catalogs.

``lower(job)`` is the single tiling implementation behind every
strategy (formerly six near-identical ``catalog_for_*`` builders): each
task's [a0, a0+alen) × [b0, b0+blen) window is intersected with the
aligned (block_m, block_n) grid, tiles that cannot contain a live cell
(entirely on/below the diagonal for triangular tasks, entirely above
the band) are pruned, and every surviving tile carries the task's
predicate scalars verbatim — the catalog column layout is owned by
``kernels.pair_sim`` (NCOLS = 13).

Memory: the catalog is O(#tasks + planned_pairs / (bm·bn)), never
O(P) host-side pair indices.

This module also owns the one-and-only pair-enumeration oracle
(``enumerate_catalog_pairs`` / ``enumerate_task_pairs``) — the
triangular/rect logic the reference executor and the coverage tests
share (formerly duplicated between ``er/pipeline._tile_pairs`` and
``er/executor.enumerate_catalog_pairs``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .ir import (A_TILE, B_TILE, R0, R1, C0, C1, TRI, LB_R, LB_C, UB_R,
                 UB_C, BAND, RED, NCOLS, NO_LB, NO_UB, RED_FREE,
                 T_A0, T_ALEN, T_B0, T_BLEN, T_TRI, T_LB_R, T_LB_C,
                 T_UB_R, T_UB_C, T_BAND, T_RED, MatchJob, TileCatalog)

__all__ = [
    "task_tiles",
    "lower",
    "pad_tiles",
    "pad_catalog",
    "enumerate_task_pairs",
    "enumerate_catalog_pairs",
]


def task_tiles(a0: int, alen: int, b0: int, blen: int, tri: bool,
               reducer: int, bm: int, bn: int,
               lb: Tuple[int, int] = (NO_LB, NO_LB),
               ub: Tuple[int, int] = (NO_UB, NO_UB),
               band: int = 0) -> np.ndarray:
    """Aligned tiles intersecting one task's [a0, a0+alen) × [b0, b0+blen)
    window. Validity windows/cuts are global-row predicates, so every tile
    of a task carries the same scalars; triangular tasks drop tiles
    entirely on/below the diagonal (no row < col cell), banded tasks
    additionally drop tiles entirely above the col − row < band diagonal —
    the tile set hugs the band instead of filling the bounding rectangle."""
    if alen <= 0 or blen <= 0:
        return np.zeros((0, NCOLS), np.int32)
    ii = np.arange(a0 // bm, -(-(a0 + alen) // bm), dtype=np.int64)
    jj = np.arange(b0 // bn, -(-(b0 + blen) // bn), dtype=np.int64)
    tii, tjj = np.meshgrid(ii, jj, indexing="ij")
    tii, tjj = tii.ravel(), tjj.ravel()
    if tri:
        keep = np.maximum(tii * bm, a0) < np.minimum((tjj + 1) * bn, b0 + blen)
        tii, tjj = tii[keep], tjj[keep]
    if band > 0:
        # Some cell with col − row < band: min over the tile∩window of
        # (col − row) is clipped_col_start − (clipped_row_end − 1).
        keep = (np.maximum(tjj * bn, b0)
                < np.minimum((tii + 1) * bm, a0 + alen) + band - 1)
        tii, tjj = tii[keep], tjj[keep]
    t = np.empty((tii.size, NCOLS), np.int32)
    t[:, A_TILE] = tii
    t[:, B_TILE] = tjj
    t[:, R0] = a0
    t[:, R1] = a0 + alen
    t[:, C0] = b0
    t[:, C1] = b0 + blen
    t[:, TRI] = int(tri)
    t[:, LB_R], t[:, LB_C] = lb
    t[:, UB_R], t[:, UB_C] = ub
    t[:, BAND] = band
    t[:, RED] = reducer
    return t


def lower(job: MatchJob, block_m: int = 128,
          block_n: int = 128) -> TileCatalog:
    """Tile a MatchJob into an MXU tile catalog.

    Tiles inherit their task's reducer attribution; tasks marked
    :data:`ir.RED_FREE` (no planner attribution, e.g. the match_⊥ cross
    job) get their tiles spread round-robin over the job's r reducers —
    the cost-LPT scheduler re-places everything anyway, this only keeps
    the unscheduled catalog balanced for the legacy/round-robin paths.
    """
    parts = []
    for t in job.tasks:
        parts.append(task_tiles(
            int(t[T_A0]), int(t[T_ALEN]), int(t[T_B0]), int(t[T_BLEN]),
            bool(t[T_TRI]), int(t[T_RED]), block_m, block_n,
            lb=(int(t[T_LB_R]), int(t[T_LB_C])),
            ub=(int(t[T_UB_R]), int(t[T_UB_C])),
            band=int(t[T_BAND])))
    tiles = (np.concatenate(parts, axis=0) if parts
             else np.zeros((0, NCOLS), np.int32))
    free = tiles[:, RED] == RED_FREE
    if free.any():
        tiles[free, RED] = (np.arange(int(free.sum()), dtype=np.int32)
                            % max(job.r, 1))
    return TileCatalog(tiles=tiles, block_m=block_m, block_n=block_n,
                       n_rows_a=job.n_rows_a, n_rows_b=job.n_rows_b,
                       r=max(job.r, 1), total_pairs=job.total_pairs)


# ---------------------------------------------------------------------------
# Shape padding (the serving path's fixed-shape contract)
# ---------------------------------------------------------------------------

def pad_tiles(tiles: np.ndarray, multiple: int) -> np.ndarray:
    """Pad a tile table's second-to-last axis UP to a multiple of
    ``multiple`` rows (>= one full chunk) with all-zero entries — an
    empty validity window r0 == r1 == 0 masks everything out, so padding
    never changes survivors. Works on a flat (T, NCOLS) catalog and on
    per-device (n_dev, cap, NCOLS) shards alike; this is the one padding
    helper behind the former ``pad_catalog_tiles`` / ``_pad_tile_chunks``
    / ``pad_device_tiles`` trio."""
    t = tiles.shape[-2]
    padded = max(multiple, -(-t // multiple) * multiple)
    if padded == t:
        return tiles
    pad_shape = tiles.shape[:-2] + (padded - t, NCOLS)
    return np.concatenate(
        [tiles, np.zeros(pad_shape, np.int32)], axis=-2)


def pad_catalog(catalog: TileCatalog, multiple: int) -> TileCatalog:
    """Pad a catalog's tile table to a multiple of ``multiple`` rows, so
    a chunked scorer sees only one chunk shape — the shape-bucketing the
    serving path relies on for zero steady-state recompiles."""
    tiles = pad_tiles(catalog.tiles, multiple)
    if tiles is catalog.tiles:
        return catalog
    return TileCatalog(tiles=tiles, block_m=catalog.block_m,
                       block_n=catalog.block_n, n_rows_a=catalog.n_rows_a,
                       n_rows_b=catalog.n_rows_b, r=catalog.r,
                       total_pairs=catalog.total_pairs)


# ---------------------------------------------------------------------------
# Pair-enumeration oracle (tests + the reference executor)
# ---------------------------------------------------------------------------

def enumerate_task_pairs(a0: int, alen: int, b0: int, blen: int,
                         tri: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Row-index pairs of one plain match task (no cuts/band) — the
    reference executor's O(pairs) materialization; the catalog path never
    calls this."""
    if tri:
        x, y = np.triu_indices(alen, k=1)
        return a0 + x, a0 + y
    x, y = np.meshgrid(np.arange(alen), np.arange(blen), indexing="ij")
    return a0 + x.ravel(), b0 + y.ravel()


def enumerate_catalog_pairs(catalog: TileCatalog
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Materialize every pair a catalog covers (numpy, O(P) — tests only).

    Applies the exact kernel predicate per tile; the parity tests assert
    this equals the plan's own pair enumeration, i.e. the catalog covers
    each planned pair exactly once.
    """
    bm, bn = catalog.block_m, catalog.block_n
    gi = np.arange(bm)[:, None]
    gj = np.arange(bn)[None, :]
    out_a, out_b = [], []
    for e in catalog.tiles:
        rows = e[A_TILE].astype(np.int64) * bm + gi
        cols = e[B_TILE].astype(np.int64) * bn + gj
        keep = (rows >= e[R0]) & (rows < e[R1]) & (cols >= e[C0]) & (cols < e[C1])
        if e[TRI]:
            keep &= rows < cols
        keep &= (rows > e[LB_R]) | (cols >= e[LB_C])
        keep &= (rows < e[UB_R]) | (cols <= e[UB_C])
        if e[BAND]:
            keep &= cols - rows < e[BAND]
        ii, jj = np.nonzero(keep)
        out_a.append(rows[ii, 0])
        out_b.append(cols[0, jj])
    if not out_a:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(out_a), np.concatenate(out_b)

"""Distributed ER runtime: the paper's two MR jobs on a device mesh.

Port of ``repro.er.distributed``. Mapping: input partition Π_i ↔ the row
shard of data position i; the shuffle ↔ a gather between the shards'
devices; a reduce task ↔ a work shard run by one device. One process
drives every shard (:mod:`repro_torch.sharding`), as the reference's
``shard_map`` programs are driven by one process; the number of logical
reduce tasks ``r`` stays decoupled from the device count, as in the
paper.

Job 1 (:func:`compute_bdm_sharded`): each shard bincounts its local
blocking keys — its BDM *column* — and one all-gather produces the full
b × m matrix. Alg. 3 with the footnote-2 combiner built in.

Job 2 runs through the compiler (``er/compiler``): any plan lowers to a
tile catalog, the cost-LPT scheduler places tiles on reducers and
devices, and ``compiler.execute`` scores every shard through the catalog
kernels on its device. The entry points here — ``match_catalog_dist``
(self-join), ``match_catalog_2src_dist`` (query-vs-corpus) and
``match_sn_dist`` (RepSN halo exchange) — are thin shims over that
executor. Two legacy executors remain as comparison baselines:

  * :func:`match_pair_range_dist` — every shard derives its own pair list
    from the tiny plan arrays by the closed-form inverse
    (``core.pair_range.pairs_of_range_torch``), the paper's map-side
    "relevant ranges" computation;
  * :func:`match_shards_hostplan` — per-device padded row-index arrays,
    O(P) host memory.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.pair_range import PairRangePlan, pairs_of_range_torch
from ..core.sorted_neighborhood import _w_eff
from ..sharding import Mesh, all_gather, shard_rows
from .compiler import (DeviceKilledError, FaultEvent, FaultInjector,
                       FaultScript, MatchJob, NoHealthyDevicesError,
                       RecoveryFailedError, SupervisedReport, TileCatalog,
                       TransientScorerError, device_assignment, execute,
                       execute_supervised, lower, make_scorer, pad_tiles,
                       shard_sane, tiles_for_devices)
from .compiler.comms import halo_bytes_per_device
from .compiler.execute import _mesh_operands, _score_and_compact
from .compiler.ir import make_job, task_row
from .similarity import two_stage_match

__all__ = [
    "compute_bdm_sharded",
    # fault-tolerant runtime (passed through from er/compiler)
    "DeviceKilledError",
    "FaultEvent",
    "FaultInjector",
    "FaultScript",
    "NoHealthyDevicesError",
    "RecoveryFailedError",
    "SupervisedReport",
    "TransientScorerError",
    "execute_supervised",
    "shard_sane",
    "match_catalog_dist",
    "match_catalog_2src_dist",
    "make_catalog_2src_scorer",
    "score_tiles_2src",
    "match_pair_range_dist",
    "match_sn_dist",
    "match_shards_hostplan",
    "device_assignment",
    "plan_rows_for_devices",
    "plan_tiles_for_devices",
    "pad_device_tiles",
    "sn_replication_volume",
]


# ---------------------------------------------------------------------------
# Job 1: BDM
# ---------------------------------------------------------------------------

def compute_bdm_sharded(block_ids, num_blocks: int, mesh: Mesh,
                        axis: str = "data") -> torch.Tensor:
    """block_ids: (n,) ints, n divisible by the size of ``axis``; data
    position i's row shard is input partition Π_i. Each shard bincounts
    its keys on its device, one all-gather assembles the columns. Returns
    the (b, m) int32 BDM on the mesh's first device, m = the axis size."""
    ids = torch.as_tensor(np.asarray(block_ids)).reshape(-1, 1)
    grid = mesh.grid(axis)
    shards = shard_rows(ids, grid).column(0)
    cols = [torch.bincount(s.reshape(-1).to(torch.int64),
                           minlength=num_blocks)[None] for s in shards]
    return all_gather(cols, [grid[0, 0]])[0].T.to(torch.int32)


# ---------------------------------------------------------------------------
# Tile routing shims (scheduling lives in compiler/schedule.py)
# ---------------------------------------------------------------------------

def plan_tiles_for_devices(catalog: TileCatalog, n_dev: int,
                           healthy: Optional[np.ndarray] = None,
                           schedule=None) -> np.ndarray:
    """Partition a tile catalog over devices — see
    :func:`compiler.tiles_for_devices`. Without a schedule, reducers
    route round-robin via :func:`device_assignment` (the baseline)."""
    return tiles_for_devices(catalog, n_dev, healthy, schedule)


def pad_device_tiles(tiles_dev: np.ndarray, chunk: int) -> np.ndarray:
    """Pad the per-device tile cap UP to a multiple of ``chunk`` (>= one
    full chunk) with all-zero entries (:func:`compiler.pad_tiles`)."""
    return pad_tiles(tiles_dev, chunk)


def plan_rows_for_devices(reducer_rows, r: int, n_dev: int,
                          healthy: Optional[np.ndarray] = None
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate per-reducer (rows_a, rows_b) into per-device padded
    arrays (n_dev, cap). Returns (rows_a, rows_b, valid). Feeds the
    legacy O(P) :func:`match_shards_hostplan` executor only."""
    dev_of = device_assignment(r, n_dev, healthy)
    per_dev_a = [[] for _ in range(n_dev)]
    per_dev_b = [[] for _ in range(n_dev)]
    for k in range(r):
        ra, rb = reducer_rows[k]
        d = int(dev_of[k])
        per_dev_a[d].append(np.asarray(ra, np.int32))
        per_dev_b[d].append(np.asarray(rb, np.int32))
    cat_a = [np.concatenate(x) if x else np.zeros(0, np.int32)
             for x in per_dev_a]
    cat_b = [np.concatenate(x) if x else np.zeros(0, np.int32)
             for x in per_dev_b]
    cap = max(1, max(a.shape[0] for a in cat_a))
    rows_a = np.zeros((n_dev, cap), np.int32)
    rows_b = np.zeros((n_dev, cap), np.int32)
    valid = np.zeros((n_dev, cap), bool)
    for d in range(n_dev):
        c = cat_a[d].shape[0]
        rows_a[d, :c] = cat_a[d]
        rows_b[d, :c] = cat_b[d]
        valid[d, :c] = True
    return rows_a, rows_b, valid


# ---------------------------------------------------------------------------
# Job 2: executor shims
# ---------------------------------------------------------------------------

def match_catalog_dist(feats, catalog: TileCatalog, mesh: Mesh,
                       axis: str = "data", threshold: float = 0.8,
                       impl: str = "auto",
                       healthy: Optional[np.ndarray] = None,
                       chunk_tiles: int = 1024, schedule=None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Stage 1 of any self-join plan on a mesh: features (n, d) f32 in the
    blocked layout, row-sharded over ``axis``; each device gathers them
    and scores its tile shard (:func:`compiler.execute`, mode "self");
    pass ``schedule=`` for cost-LPT placement instead of the reducer
    round-robin. Returns the stage-1 survivor candidates (rows_a, rows_b)
    as host int64 arrays; run stage 2 with ``compiler.verify_pairs``."""
    return execute(catalog, feats, threshold=threshold, impl=impl,
                   mesh=mesh, axis=axis, healthy=healthy,
                   chunk_tiles=chunk_tiles, schedule=schedule)


def make_catalog_2src_scorer(mesh: Mesh, axis: str = "data", *,
                             threshold: float, block_m: int = 128,
                             block_n: int = 128, impl: str = "auto"):
    """ONE sharded-index scorer for query-vs-corpus catalogs: corpus
    row-sharded and gathered, query batch replicated — see
    :func:`compiler.make_scorer` (mode "cross"). Build it once per
    resident service and reuse it for every micro-batch."""
    return make_scorer(mesh, axis, mode="cross", threshold=threshold,
                       block_m=block_m, block_n=block_n, impl=impl)


def score_tiles_2src(scorer, feats_a, feats_b, tiles_dev: np.ndarray,
                     chunk: int, bm: int, bn: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Drive a :func:`make_catalog_2src_scorer` over per-device tile
    shards, ``chunk`` tiles per device at a time (``tiles_dev`` pre-padded
    via :func:`pad_device_tiles`), compacting each chunk's survivors into
    global (rows_a, rows_b)."""
    return _score_and_compact(scorer, _mesh_operands(scorer.grid, feats_a,
                                                     feats_b),
                              tiles_dev, chunk, bm, bn)


def match_catalog_2src_dist(feats_a, feats_b, catalog: TileCatalog,
                            mesh: Mesh, axis: str = "data",
                            threshold: float = 0.8, impl: str = "auto",
                            healthy: Optional[np.ndarray] = None,
                            chunk_tiles: int = 1024, schedule=None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot sharded-index cross matcher: stage 1 of a two-source
    catalog with the corpus (a-side) row-sharded over ``axis`` and the
    query batch (b-side) replicated. Builds a fresh scorer — resident
    services hold a :func:`make_catalog_2src_scorer` instead."""
    return execute(catalog, feats_a, feats_b, threshold=threshold,
                   impl=impl, mesh=mesh, axis=axis, healthy=healthy,
                   chunk_tiles=chunk_tiles, schedule=schedule,
                   fixed_chunks=True)


def sn_replication_volume(n: int, w: int, n_dev: int, feature_dim: int,
                          itemsize: int = 4, per_hop: bool = False):
    """Job-2 interconnect bytes *received* across all devices:
    (boundary replication, full all-gather) — or, with ``per_hop``, the
    per-device hop-by-hop byte schedule of the multi-hop halo chain.

    RepSN replicates only the w−1 boundary rows between adjacent shards —
    O(n_dev · w · d) — where the generic executors all-gather the whole
    feature matrix, O(n_dev · n · d). When w − 1 > n/n_dev the halo
    crosses ⌈(w−1)/n_loc⌉ shards via chained hops, the last one sending
    only the final partial strip, so the total stays exactly
    n_dev · (w−1) · d · itemsize; ``per_hop=True`` returns the per-device
    hop list [n_loc·row_bytes, …, take·row_bytes].
    """
    halo = _w_eff(n, w) - 1
    if n_dev <= 1:          # single device: the halo ppermute is a
        return ([] if per_hop else (0, 0))   # self-send — nothing
    n_loc = n // n_dev      # crosses the wire
    if per_hop:
        return halo_bytes_per_device(n_loc, halo, feature_dim, itemsize)
    return (n_dev * halo * feature_dim * itemsize,
            n_dev * (n - n_loc) * feature_dim * itemsize)


def match_sn_dist(feats, w: int, mesh: Mesh, axis: str = "data",
                  threshold: float = 0.8, impl: str = "auto",
                  block_m: int = 128, block_n: int = 128,
                  chunk_tiles: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """Stage 1 of Sorted Neighborhood on a mesh, RepSN-style.

    feats (n, d) f32 in *sorted-key order*, row-sharded over ``axis`` (n
    must divide evenly). Device d owns every band pair whose smaller
    sorted position falls in its shard, and fetches only the w−1 boundary
    rows of the following shards by chained neighbor ppermutes — no
    all-gather (:func:`sn_replication_volume` accounts the byte gap). The
    shard's band job is compiled host-side in shard-local coordinates over
    the concatenated [local ‖ halo] strip as ONE banded task per device
    with reducer = device; the wrapped halo of the last device is masked
    out by its task's column window. Any window size. Returns stage-1
    survivor candidates (rows_a, rows_b) as sorted-order host int64
    arrays; run stage 2 with ``compiler.verify_pairs``.
    """
    n = int(feats.shape[0])
    n_dev = int(mesh.shape[axis])
    if n % n_dev:
        raise ValueError(f"n={n} not divisible by n_dev={n_dev}")
    n_loc = n // n_dev
    we = _w_eff(n, w)
    halo = we - 1

    rows = []
    for dev in range(n_dev):
        c1 = min(n - dev * n_loc, n_loc + halo)   # last shard: mask the wrap
        rows.append(task_row(0, n_loc, 1, c1 - 1, True, dev, band=we))
    # total_pairs = 0: per-shard band pair counts are owned by the
    # SortedNeighborhoodPlan; this job is routing geometry only.
    job: MatchJob = make_job(rows, n_loc + halo, n_loc + halo, n_dev, 0)
    catalog = lower(job, block_m, block_n)
    base = np.arange(n_dev, dtype=np.int64) * n_loc
    return execute(catalog, feats, threshold=threshold, impl=impl,
                   mesh=mesh, axis=axis, chunk_tiles=chunk_tiles,
                   halo=halo, base=base)


# ---------------------------------------------------------------------------
# Legacy executors (comparison baselines)
# ---------------------------------------------------------------------------

def _gathered(mesh: Mesh, axis: str, *arrays):
    """Each array row-sharded over ``axis`` and all-gathered back onto
    every data position: per position, the tuple of gathered tensors."""
    grid = mesh.grid(axis)
    devs = list(grid[:, 0])
    per = [all_gather(shard_rows(_rows2d(x), grid).column(0), devs)
           for x in arrays]
    return [tuple(p[d].reshape((-1,) + tuple(np.shape(x)[1:]))
                  for p, x in zip(per, arrays)) for d in range(len(devs))]


def _rows2d(x):
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.reshape(t.shape[0], -1)


def _match_local(feats, codes, lens, ra, rb, valid, threshold, margin):
    mask, score = two_stage_match(
        feats[ra], feats[rb], codes[ra], lens[ra], codes[rb], lens[rb],
        threshold=threshold, filter_margin=margin)
    mask = mask & valid
    return mask, torch.where(mask, score, torch.zeros((), device=mask.device))


def match_pair_range_dist(feats, codes, lens, plan: PairRangePlan,
                          mesh: Mesh, axis: str = "data",
                          threshold: float = 0.8,
                          filter_margin: float = 0.25):
    """PairRange on a mesh, the map side's closed form on every shard.

    feats (n, d) f32 / codes (n, L) uint8 / lens (n,) int32 are in the
    *blocked layout*, row-sharded over ``axis`` and gathered onto every
    shard. Shard d owns the contiguous pair range [d·cap, (d+1)·cap) with
    cap = ⌈P/n_dev⌉ — the paper's eq. (2) with r = n_dev — and derives its
    pairs on its device with ``pairs_of_range_torch``.

    Returns (rows_a, rows_b, mask, score), each (n_dev, cap) on the
    mesh's first device, row d holding shard d's results.
    """
    n_dev = int(mesh.shape[axis])
    total = int(plan.total_pairs)
    cap = max(1, -(-total // n_dev))
    grid = mesh.grid(axis)
    outs = []
    for d, (fg, cg, lg) in enumerate(_gathered(mesh, axis, feats, codes,
                                               lens)):
        dev = grid[d, 0]
        ra, rb, valid = pairs_of_range_torch(
            torch.as_tensor(plan.block_sizes).to(dev),
            torch.as_tensor(plan.offsets).to(dev),
            torch.as_tensor(plan.estart).to(dev), d * cap, cap, total)
        mask, score = _match_local(fg, cg, lg, ra, rb, valid, threshold,
                                   filter_margin)
        outs.append((ra, rb, mask, score))
    first = mesh.first_device
    return tuple(torch.stack([o[i].to(first) for o in outs])
                 for i in range(4))


def match_shards_hostplan(feats, codes, lens, rows_a, rows_b, valid,
                          mesh: Mesh, axis: str = "data",
                          threshold: float = 0.8,
                          filter_margin: float = 0.25):
    """LEGACY executor: per-device padded row pairs (from
    :func:`plan_rows_for_devices`), row-sharded features gathered onto
    every shard — O(P) host memory. Returns (mask, score), each
    (n_dev, cap) on the mesh's first device. Use
    :func:`match_catalog_dist` for the O(#tiles) catalog path."""
    grid = mesh.grid(axis)
    first = mesh.first_device
    masks, scores = [], []
    for d, (fg, cg, lg) in enumerate(_gathered(mesh, axis, feats, codes,
                                               lens)):
        dev = grid[d, 0]
        mask, score = _match_local(
            fg, cg, lg, torch.as_tensor(np.asarray(rows_a[d])).to(dev).long(),
            torch.as_tensor(np.asarray(rows_b[d])).to(dev).long(),
            torch.as_tensor(np.asarray(valid[d])).to(dev), threshold,
            filter_margin)
        masks.append(mask.to(first))
        scores.append(score.to(first))
    return torch.stack(masks), torch.stack(scores)

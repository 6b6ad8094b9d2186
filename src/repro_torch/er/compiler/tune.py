"""Tile-geometry autotuning: pick per-catalog (block_m, block_n) from the
kernel's lattice by exact occupancy, refined online by wall clock.

Port of ``repro.er.compiler.tune``. The lowering quantum is both the
load-balance floor (the paper balances at sub-block granularity, §IV)
and the catalog kernel's occupancy knob: a skewed BDM's long tail of
small blocks lowers into tiles that are mostly dead cells at 128×128, and
the kernel multiplies padding. Two signals rank the lattice:

  * **Exact occupancy** (static): lower the job at each candidate
    geometry and take ``waste = T·bm·bn − Σ tile_costs``. The live-pair
    sum is geometry-invariant (the plan's pair total; only the dead
    padding moves) and ``tile_costs`` is exact, so the waste equals the
    enumerated dead cells. The static score adds per-tile strip traffic
    and a fixed per-tile overhead on top of the cell count:
    ``T·(bm·bn + beta·(bm+bn) + tile_overhead)``, in cell-equivalents,
    so tiny tiles cannot win on occupancy alone.
  * **Measured seconds-per-live-pair** (online): a geometry-keyed EWMA
    (:class:`~.feedback.GeometryCostModel`). Measured candidates rank by
    their EWMA rate; unmeasured ones are bridged through a fitted
    seconds-per-model-unit scale.

Candidates the CUDA kernel cannot run are dropped before scoring: a
geometry off the kernel's lattice, or one whose block needs more shared
memory than an H100 block may use (:func:`~...kernels.pair_sim.
catalog_smem_bytes` against ``SMEM_BUDGET_BYTES``). That model stages d
in 32-column chunks and writes survivors straight to device memory, so
neither the feature width nor the compaction capacity enters it (the
JAX package's VMEM model has both); ``d`` and ``capacity`` stay in the
signature for parity. Every point of the lattice fits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from ...kernels.pair_sim import (GEOMETRY_LATTICE, SMEM_BUDGET_BYTES,
                                 catalog_smem_bytes)
from .feedback import GeometryCostModel
from .ir import MatchJob, TileCatalog
from .lower import lower
from .schedule import tile_costs

__all__ = [
    "GEOMETRY_LATTICE",
    "GeometryScore",
    "TuneReport",
    "catalog_occupancy",
    "autotune",
]

# Static-model coefficients in dead-cell equivalents, the JAX package's:
# ``beta`` weighs per-tile strip traffic (bm+bn rows per tile),
# ``tile_overhead`` the fixed per-tile cost (entry decode, epilogue). With
# the same coefficients the static pick equals the JAX package's; measured
# rates on this card override them as soon as the EWMA has any.
DEFAULT_BETA = 32.0
DEFAULT_TILE_OVERHEAD = 4096.0


@dataclass(frozen=True)
class GeometryScore:
    """One lattice candidate's exact occupancy + model/measured cost."""
    block_m: int
    block_n: int
    tiles: int              # catalog entries T at this geometry
    cells: int              # T · bm · bn scored cells
    live_pairs: int         # Σ tile_costs — geometry-invariant
    waste: int              # cells − live_pairs (exact dead cells)
    occupancy: float        # live_pairs / cells (0 for empty catalogs)
    model_cost: float       # static model, cell-equivalents
    measured_rate: float    # EWMA seconds/live-pair; NaN if unmeasured
    predicted_seconds: float  # NaN when nothing in the lattice is measured

    @property
    def geometry(self) -> Tuple[int, int]:
        return (self.block_m, self.block_n)


@dataclass(frozen=True)
class TuneReport:
    """Autotune outcome: the chosen geometry + the full candidate table
    (sorted best-first)."""
    block_m: int
    block_n: int
    measured: bool          # True when the choice used EWMA wall clock
    scores: Tuple[GeometryScore, ...]

    @property
    def geometry(self) -> Tuple[int, int]:
        return (self.block_m, self.block_n)

    @property
    def best(self) -> GeometryScore:
        return self.scores[0]


def catalog_occupancy(catalog: TileCatalog) -> Tuple[int, int, int]:
    """(cells, live_pairs, waste) of a lowered catalog — exact, from the
    closed-form cost model. ``waste`` equals the number of tile cells
    whose predicate mask is dead."""
    t = catalog.tiles.shape[0]
    cells = t * catalog.block_m * catalog.block_n
    live = int(tile_costs(catalog).sum())
    return cells, live, cells - live


def _score_one(job: MatchJob, bm: int, bn: int, beta: float,
               tile_overhead: float,
               feedback: Optional[GeometryCostModel]) -> GeometryScore:
    catalog = lower(job, bm, bn)
    cells, live, waste = catalog_occupancy(catalog)
    t = catalog.tiles.shape[0]
    model = t * (bm * bn + beta * (bm + bn) + tile_overhead)
    rate = feedback.rate((bm, bn)) if feedback is not None else float("nan")
    return GeometryScore(
        block_m=bm, block_n=bn, tiles=t, cells=cells, live_pairs=live,
        waste=waste, occupancy=(live / cells if cells else 0.0),
        model_cost=model, measured_rate=rate,
        predicted_seconds=float("nan"))


def _runs_on_the_kernel(bm: int, bn: int) -> bool:
    return ((bm, bn) in GEOMETRY_LATTICE
            and catalog_smem_bytes(bm, bn) <= SMEM_BUDGET_BYTES)


def autotune(job: MatchJob, *,
             lattice: Sequence[Tuple[int, int]] = GEOMETRY_LATTICE,
             d: int = 0, capacity: int = 0, beta: float = DEFAULT_BETA,
             tile_overhead: float = DEFAULT_TILE_OVERHEAD,
             feedback: Optional[GeometryCostModel] = None) -> TuneReport:
    """Choose (block_m, block_n) for ``job`` from ``lattice``.

    Candidates the CUDA kernel cannot run are dropped (see the module
    docstring; ``d`` and ``capacity`` do not enter the Hopper model).
    With a :class:`GeometryCostModel` holding at least one measured
    candidate, ranking is by predicted wall seconds — measured candidates
    at ``rate · live_pairs``, unmeasured ones bridged via the fitted
    seconds-per-model-unit of the measured set. Otherwise ranking is by
    the static model alone.
    """
    del d, capacity
    cands = [(int(bm), int(bn)) for bm, bn in lattice
             if _runs_on_the_kernel(int(bm), int(bn))]
    if not cands:
        raise ValueError(f"no candidate of {tuple(lattice)} runs on the "
                         f"kernel (lattice {GEOMETRY_LATTICE}, shared "
                         f"memory budget {SMEM_BUDGET_BYTES} B)")

    scores = [_score_one(job, bm, bn, beta, tile_overhead, feedback)
              for bm, bn in cands]

    # Wall-clock anchor: fit seconds-per-model-unit over measured
    # candidates, project it onto unmeasured ones. live_pairs is the
    # same for every candidate, so measured ranks need no bridging among
    # themselves — the fit only grafts the two populations onto one axis.
    measured = [s for s in scores if not math.isnan(s.measured_rate)]
    use_measured = bool(measured)
    if use_measured:
        kappa = float(np.mean([s.measured_rate * max(s.live_pairs, 1)
                               / s.model_cost for s in measured]))
        scores = [
            GeometryScore(
                **{**s.__dict__,
                   "predicted_seconds":
                       (s.measured_rate * max(s.live_pairs, 1)
                        if not math.isnan(s.measured_rate)
                        else kappa * s.model_cost)})
            for s in scores]
        scores.sort(key=lambda s: s.predicted_seconds)
    else:
        scores.sort(key=lambda s: s.model_cost)

    best = scores[0]
    return TuneReport(block_m=best.block_m, block_n=best.block_n,
                      measured=use_measured, scores=tuple(scores))

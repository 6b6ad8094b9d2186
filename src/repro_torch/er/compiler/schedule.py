"""Cost-model tile scheduling: tiles → reducers → devices via greedy LPT.

The paper's point (§IV) is that load balance comes from scheduling match
work by its TRUE cost, not by block or tile count. After lowering, the
unit of work is a catalog tile, and its true cost is the number of cells
that survive the tile's predicates — corner-cut tiles at a PairRange
boundary may hold 3 live pairs while an interior tile holds bm·bn. The
cost model here is **exact**: every predicate the kernel evaluates
(validity window, triangular mask, lb/ub corner cuts, the SN band) is a
per-row column *interval* constraint, so the live count is a sum of bm
interval lengths — O(T·bm), closed form, no enumeration.

``schedule_tiles`` feeds those costs to ``core.assignment.greedy_lpt``
twice — tiles → r reducers, then reducer loads → healthy devices —
replacing the per-strategy hardcoded reducer column and the
reducer → device round-robin. Round-robin remains available as the
baseline policy (and the elasticity unit ``device_assignment`` keeps its
pure-function-of-(r, healthy) restart story).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ...core.assignment import greedy_lpt, greedy_lpt_hetero, makespan_stats
from .ir import (A_TILE, B_TILE, R0, R1, C0, C1, TRI, LB_R, LB_C, UB_R,
                 UB_C, BAND, RED, NCOLS, TileCatalog)

__all__ = [
    "NoHealthyDevicesError",
    "Schedule",
    "tile_costs",
    "schedule_tiles",
    "apply_schedule",
    "tiles_for_devices",
    "device_assignment",
]


class NoHealthyDevicesError(ValueError):
    """Every device in the healthy mask is down — nothing can run.

    A ValueError subclass so callers that matched the former bare
    ``ValueError("no healthy devices")`` keep working; the service layer
    turns it into a clean retry-after error instead of a traceback."""

_COST_SLAB = 65_536     # tiles per cost-model slab: caps peak memory at
                        # O(slab · block_m) int64 regardless of plan size

POLICIES = ("cost_lpt", "round_robin")


def tile_costs(catalog: TileCatalog) -> np.ndarray:
    """Exact live-pair count per tile under ALL catalog predicates.

    For a fixed row, every predicate constrains the column to one
    interval: the validity window gives [c0, c1), the tile bounds give
    [b_tile·bn, (b_tile+1)·bn), tri demands col ≥ row+1, the band
    demands col < row+band, the lb cut applies col ≥ lb_c only on rows
    ≤ lb_r, the ub cut applies col ≤ ub_c only on rows ≥ ub_r. The live
    count is Σ_rows max(0, hi − lo) — exact, vectorized, O(T·bm)."""
    tiles = catalog.tiles
    if tiles.shape[0] == 0:
        return np.zeros(0, np.int64)
    bm, bn = catalog.block_m, catalog.block_n
    ar = np.arange(bm, dtype=np.int64)[None, :]
    out = np.empty(tiles.shape[0], np.int64)
    for s in range(0, tiles.shape[0], _COST_SLAB):
        t = tiles[s:s + _COST_SLAB].astype(np.int64)
        rows = t[:, A_TILE, None] * bm + ar
        lo = np.maximum(t[:, C0, None], t[:, B_TILE, None] * bn)
        hi = np.minimum(t[:, C1, None], (t[:, B_TILE, None] + 1) * bn)
        lo = np.where(t[:, TRI, None] != 0, np.maximum(lo, rows + 1), lo)
        hi = np.where(t[:, BAND, None] > 0,
                      np.minimum(hi, rows + t[:, BAND, None]), hi)
        lo = np.where(rows <= t[:, LB_R, None],
                      np.maximum(lo, t[:, LB_C, None]), lo)
        hi = np.where(rows >= t[:, UB_R, None],
                      np.minimum(hi, t[:, UB_C, None] + 1), hi)
        valid = (rows >= t[:, R0, None]) & (rows < t[:, R1, None])
        out[s:s + _COST_SLAB] = (np.maximum(hi - lo, 0) * valid).sum(axis=1)
    return out


@dataclass(frozen=True)
class Schedule:
    """A placement of catalog tiles onto reducers onto devices."""
    policy: str
    tile_cost: np.ndarray       # (T,) exact live pairs per tile
    tile_reducer: np.ndarray    # (T,) tile → reduce task
    reducer_device: np.ndarray  # (r,) reduce task → device
    reducer_load: np.ndarray    # (r,) live pairs per reduce task
    device_load: np.ndarray     # (n_dev,) live pairs per device
    healthy: np.ndarray         # (n_dev,) bool
    # Runtime-feedback calibration (None without an EwmaCostModel):
    device_rate: Optional[np.ndarray] = None  # (n_dev,) s per live pair
    predicted_s: Optional[np.ndarray] = None  # (n_dev,) projected seconds
    # Interconnect plan (None = flat all-gather): a comms.CommsPlan.
    # When set, ``execute`` uses ITS locality tile placement instead of
    # the cost-LPT one above (the hop bound depends on it) and surfaces
    # the plan's byte accounting through ``stats()``.
    comms: Optional[object] = None

    @property
    def n_dev(self) -> int:
        return int(self.device_load.shape[0])

    @property
    def calibrated(self) -> bool:
        return self.predicted_s is not None

    def stats(self) -> Dict:
        """The paper's balance metrics at both scheduling levels, plus —
        when the schedule was EWMA-calibrated — the wall-clock makespan
        the feedback model projects (compare against the supervisor's
        ``SupervisedReport.measured_makespan_s``)."""
        out = {
            "policy": self.policy,
            "tiles": int(self.tile_cost.shape[0]),
            "total_cost": int(self.tile_cost.sum()),
            "reducer": makespan_stats(self.reducer_load),
            "device": makespan_stats(self.device_load[self.healthy]),
            "calibrated": self.calibrated,
        }
        if self.predicted_s is not None:
            alive = self.predicted_s[self.healthy]
            out["predicted_makespan_s"] = (float(alive.max())
                                           if alive.size else 0.0)
        if self.comms is not None:
            out["interconnect"] = self.comms.summary()
        return out


def device_assignment(r: int, n_dev: int,
                      healthy: Optional[np.ndarray] = None) -> np.ndarray:
    """reducer k → device, round-robin over the *healthy* devices, so a
    failed/straggling device's work shards re-spread evenly — the plan is
    a pure function of (r, healthy mask), recomputable anywhere (the BDM
    restart argument, DESIGN.md §3). The baseline the cost-LPT scheduler
    is benchmarked against, and the fallback when no schedule is given."""
    if healthy is None:
        healthy = np.ones(n_dev, bool)
    alive = np.flatnonzero(healthy)
    if alive.size == 0:
        raise NoHealthyDevicesError("no healthy devices")
    return alive[np.arange(r) % alive.size]


def schedule_tiles(catalog: TileCatalog, *, n_dev: int = 1,
                   healthy: Optional[np.ndarray] = None,
                   policy: str = "cost_lpt",
                   feedback=None, comms_plan=None) -> Schedule:
    """Assign tiles → reducers → devices.

    ``policy="cost_lpt"``: greedy LPT over exact tile costs fills the r
    reduce tasks, then greedy LPT over reducer loads fills the healthy
    devices — both via ``core.assignment.greedy_lpt`` (the paper's
    BlockSplit heuristic, applied at tile granularity).
    ``policy="round_robin"``: keep the plan's reducer attribution and
    route reducers → devices round-robin (the pre-scheduler behavior,
    kept as the benchmark baseline).

    ``feedback=`` an :class:`~.feedback.EwmaCostModel` with at least one
    observation turns the cost-LPT placement into a *calibrated* one:
    tile weights become exact live pairs × the measured per-tile-class
    rate (the exact pair counts still back every coverage metric), and
    reducer loads land on devices via finish-time LPT over the measured
    per-device rates (:func:`core.assignment.greedy_lpt_hetero`), so a
    slow device gets proportionally less work. The projection lands on
    ``Schedule.predicted_s`` / ``stats()["predicted_makespan_s"]``.

    ``comms_plan=`` attaches a :class:`~.comms.CommsPlan` — ``execute``
    then uses the plan's locality tile placement (its hop bound depends
    on tiles landing on their minimum needed strip, which overrides the
    cost-LPT device routing above; reducer attribution and the balance
    metrics are unchanged) and ``stats()`` reports the plan's per-flow
    interconnect bytes under ``"interconnect"``.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown schedule policy {policy!r}")
    if healthy is None:
        healthy = np.ones(n_dev, bool)
    healthy = np.asarray(healthy, bool)
    alive = np.flatnonzero(healthy)
    if alive.size == 0:
        raise NoHealthyDevicesError("no healthy devices")
    r = catalog.r
    costs = tile_costs(catalog)
    device_rate = predicted_s = None
    calibrate = (feedback is not None and policy == "cost_lpt"
                 and feedback.observations > 0)
    if calibrate:
        from .feedback import tile_class
        sec = costs * feedback.class_rates()[tile_class(catalog)]
        # greedy_lpt weighs int64: scale predicted seconds to ~ns so the
        # exact-cost tie-breaking order is preserved at any magnitude.
        scale = 2.0 ** 40 / max(float(sec.max()), 1e-30) if sec.size else 1.0
        tile_reducer, _ = greedy_lpt(
            np.round(sec * scale).astype(np.int64), r)
        reducer_sec = np.bincount(tile_reducer, weights=sec, minlength=r)
        device_rate = feedback.device_rates()
        rel = device_rate / max(feedback.global_rate, 1e-300)
        on_alive, _, finish = greedy_lpt_hetero(reducer_sec, rel[alive])
        reducer_device = alive[on_alive]
        predicted_s = np.zeros(n_dev)
        predicted_s[alive] = finish
        reducer_load = np.bincount(
            tile_reducer, weights=costs, minlength=r).astype(np.int64)
    elif policy == "cost_lpt":
        tile_reducer, reducer_load = greedy_lpt(costs, r)
        on_alive, _ = greedy_lpt(reducer_load, alive.size)
        reducer_device = alive[on_alive]
    else:
        tile_reducer = catalog.tiles[:, RED].astype(np.int64)
        reducer_load = np.bincount(
            tile_reducer, weights=costs, minlength=r).astype(np.int64)
        reducer_device = device_assignment(r, n_dev, healthy)
    device_load = np.bincount(
        reducer_device, weights=reducer_load, minlength=n_dev).astype(np.int64)
    return Schedule(policy=policy, tile_cost=costs,
                    tile_reducer=tile_reducer, reducer_device=reducer_device,
                    reducer_load=reducer_load, device_load=device_load,
                    healthy=healthy, device_rate=device_rate,
                    predicted_s=predicted_s, comms=comms_plan)


def apply_schedule(catalog: TileCatalog, schedule: Schedule) -> TileCatalog:
    """Rewrite the catalog's reducer column to the scheduled placement."""
    tiles = catalog.tiles.copy()
    tiles[:, RED] = schedule.tile_reducer.astype(np.int32)
    return TileCatalog(tiles=tiles, block_m=catalog.block_m,
                       block_n=catalog.block_n, n_rows_a=catalog.n_rows_a,
                       n_rows_b=catalog.n_rows_b, r=catalog.r,
                       total_pairs=catalog.total_pairs)


def tiles_for_devices(catalog: TileCatalog, n_dev: int,
                      healthy: Optional[np.ndarray] = None,
                      schedule: Optional[Schedule] = None) -> np.ndarray:
    """Partition a tile catalog over devices, per-device tile lists padded
    to a common cap with all-zero entries (empty validity window → no
    survivors). With a :class:`Schedule`, tiles follow its cost-LPT
    tile → reducer → device placement (and carry the scheduled reducer
    in their RED column); without one, reducers route round-robin via
    :func:`device_assignment`. Returns (n_dev, cap, NCOLS) int32 —
    O(#tiles) metadata, the only plan state crossing the host/device
    boundary."""
    if schedule is not None:
        if schedule.n_dev != n_dev:
            raise ValueError(
                f"schedule was built for {schedule.n_dev} devices, not {n_dev}")
        if healthy is not None and not np.array_equal(
                np.asarray(healthy, bool), schedule.healthy):
            raise ValueError(
                "healthy mask differs from the schedule's — rebuild the "
                "schedule with schedule_tiles(..., healthy=...)")
        tiles = apply_schedule(catalog, schedule).tiles
        dev = (schedule.reducer_device[schedule.tile_reducer]
               if tiles.shape[0] else np.zeros(0, np.int64))
    else:
        tiles = catalog.tiles
        dev_of = device_assignment(catalog.r, n_dev, healthy)
        dev = (dev_of[tiles[:, RED]] if catalog.num_tiles
               else np.zeros(0, np.int64))
    counts = np.bincount(dev, minlength=n_dev)
    cap = max(1, int(counts.max()) if counts.size else 1)
    out = np.zeros((n_dev, cap, NCOLS), np.int32)
    for d in range(n_dev):
        mine = tiles[dev == d]
        out[d, :mine.shape[0]] = mine
    return out

"""Runtime-feedback cost calibration: the EWMA latency model that turns
``Schedule.stats()`` from a report into a control loop.

Port of ``repro.er.compiler.feedback``: numpy host state, copied as it is
so the learned rates and their JSON snapshots are the JAX package's.

The compiler's cost model (:func:`schedule.tile_costs`) is **exact in
live pairs** but blind to **wall clock**: stage-2 survivor density makes
a banded SN tile cheaper per pair than a dense rectangle, and real
devices straggle. :class:`EwmaCostModel` closes that gap with
measurements the supervisor already produces — every accepted
:class:`~.execute.ShardRecord` is one ``(device, cost-by-tile-class,
busy seconds)`` observation folded into an exponentially weighted
moving average of *seconds per live pair*:

  * **per (device, tile class)** — the finest rate, used to predict a
    specific batch on a specific device (the work-stealing projection);
  * **per device** — the device's overall speed, used to place reducer
    loads onto heterogeneous devices (``greedy_lpt_hetero``);
  * **global** — the fleet-wide prior every unseen (device, class)
    falls back to, so one observation anywhere makes every projection
    wall-clock-scaled instead of prior-scaled.

Tile *classes* partition the catalog by predicate shape — plain
rectangles, triangular self-join tiles, SN band tiles, corner-cut
rectangles — because those are the geometries whose survivor densities
(and hence per-pair wall cost) differ systematically.
:func:`EwmaCostModel.class_rates` is the **multiplicative calibration**
``schedule_tiles`` folds onto the exact live-pair costs: calibrated
tile weight = exact pairs × class rate. The live-pair model stays the
single source of truth for coverage accounting (``reducer_load`` /
``device_load`` / ``coverage`` remain exact pair counts); calibration
only re-weights *placement*.

Virtual chaos delays count as observed time **only when an injector is
armed** — the supervisor passes ``elapsed + injected_delay`` under
injection (the simulated cluster really is that slow) and the real wall
seconds otherwise, so replayable chaos drills train the model exactly
like a slow production device would.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .ir import BAND, LB_R, NO_LB, NO_UB, TRI, UB_R, TileCatalog

__all__ = [
    "N_TILE_CLASSES",
    "TILE_CLASS_NAMES",
    "tile_class",
    "EwmaCostModel",
    "GeometryCostModel",
]

TILE_CLASS_NAMES = ("rect", "tri", "band", "cut")
N_TILE_CLASSES = len(TILE_CLASS_NAMES)


def tile_class(catalog: TileCatalog) -> np.ndarray:
    """(T,) class id per catalog tile, by predicate shape.

    ``band`` > 0 → band (SN; band tiles are also triangular, the band
    dominates the live geometry), else ``tri`` → triangular, else an
    active lb/ub corner cut → cut, else a plain rectangle.
    """
    t = catalog.tiles
    if t.shape[0] == 0:
        return np.zeros(0, np.int64)
    cut = (t[:, LB_R] != NO_LB) | (t[:, UB_R] != NO_UB)
    out = np.zeros(t.shape[0], np.int64)          # rect
    out[cut] = 3                                  # cut
    out[t[:, TRI] != 0] = 1                       # tri
    out[t[:, BAND] > 0] = 2                       # band
    return out


class EwmaCostModel:
    """EWMA of measured seconds-per-live-pair at three resolutions.

    ``observe()`` folds one accepted shard call in; ``predict()`` /
    ``predict_tiles()`` project wall seconds for a batch on a device;
    ``device_rates()`` and ``class_rates()`` are the calibration vectors
    ``schedule_tiles`` consumes. The model is cheap host state (a few
    small arrays) meant to live as long as its fleet — the service keeps
    one across requests so steady-state serving self-tunes.
    """

    def __init__(self, n_dev: int, alpha: float = 0.35,
                 prior_rate: float = 1e-7):
        if n_dev < 1:
            raise ValueError("n_dev must be >= 1")
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.n_dev = int(n_dev)
        self.alpha = float(alpha)
        self.prior_rate = float(prior_rate)
        self.observations = 0
        self._global = float(prior_rate)
        self._dev = np.full(self.n_dev, np.nan)
        self._cls = np.full((self.n_dev, N_TILE_CLASSES), np.nan)

    # -- updates ---------------------------------------------------------

    def _fold(self, old: float, new: float) -> float:
        if math.isnan(old):
            return new
        return (1.0 - self.alpha) * old + self.alpha * new

    def observe(self, device: int, cost_by_class: np.ndarray,
                seconds: float) -> None:
        """Fold one measured shard call into the model.

        ``cost_by_class`` is the batch's exact live-pair cost per tile
        class (length :data:`N_TILE_CLASSES`); ``seconds`` the device's
        busy time for the call — real wall seconds, plus the injected
        virtual delay when a fault injector is armed (and only then).
        Seconds split across classes proportionally to each class's
        *currently predicted* share, so mixed-class calls refine every
        class they touch instead of blurring them together.
        """
        cost = np.asarray(cost_by_class, np.float64)
        if cost.shape != (N_TILE_CLASSES,):
            raise ValueError(
                f"cost_by_class must have shape ({N_TILE_CLASSES},)")
        total = float(cost.sum())
        if total <= 0 or seconds < 0:
            return
        seconds = max(float(seconds), 1e-9)
        rate = seconds / total
        self._global = self._fold(self._global, rate)
        self._dev[device] = self._fold(float(self._dev[device]), rate)
        cur = np.asarray([self.rate(device, c)
                          for c in range(N_TILE_CLASSES)])
        pred = cost * cur
        denom = float(pred.sum())
        for c in np.flatnonzero(cost > 0):
            share = pred[c] / denom if denom > 0 else cost[c] / total
            self._cls[device, c] = self._fold(
                float(self._cls[device, c]), share * seconds / cost[c])
        self.observations += 1

    def reset_device(self, device: int) -> None:
        """Forget everything learned about one device (its per-class and
        per-device rates fall back to the global prior). The circuit
        breaker calls this on re-admission: rates accumulated while the
        device straggled describe the device that got evicted, not the
        recovered one that just passed a probe — keeping them would
        under-schedule a healthy device indefinitely."""
        self._dev[device] = np.nan
        self._cls[device, :] = np.nan

    # -- queries ---------------------------------------------------------

    def rate(self, device: int, cls: Optional[int] = None) -> float:
        """Seconds per live pair: (device, class) → device → global."""
        if cls is not None and not math.isnan(self._cls[device, cls]):
            return float(self._cls[device, cls])
        if not math.isnan(self._dev[device]):
            return float(self._dev[device])
        return self._global

    @property
    def global_rate(self) -> float:
        """Fleet-wide EWMA seconds per live pair (the fallback prior)."""
        return self._global

    def device_rates(self) -> np.ndarray:
        """(n_dev,) per-device seconds per live pair, global-backed."""
        return np.asarray([self.rate(d) for d in range(self.n_dev)])

    def class_rates(self) -> np.ndarray:
        """(N_TILE_CLASSES,) fleet-level seconds per live pair per tile
        class — the device-agnostic multiplicative calibration folded
        onto exact live-pair costs. Unobserved classes fall back to the
        global rate."""
        out = np.empty(N_TILE_CLASSES)
        for c in range(N_TILE_CLASSES):
            col = self._cls[:, c]
            seen = col[~np.isnan(col)]
            out[c] = float(seen.mean()) if seen.size else self._global
        return out

    def predict(self, device: int, cost_by_class: np.ndarray) -> float:
        """Projected wall seconds for a batch on ``device``."""
        cost = np.asarray(cost_by_class, np.float64)
        return float(sum(cost[c] * self.rate(device, c)
                         for c in np.flatnonzero(cost > 0)))

    def predict_tiles(self, device: int, costs: np.ndarray,
                      classes: np.ndarray) -> float:
        """Projected wall seconds for explicit (cost, class) tile lists."""
        by_class = np.bincount(classes, weights=costs,
                               minlength=N_TILE_CLASSES)
        return self.predict(device, by_class)

    # -- persistence -----------------------------------------------------

    def to_state(self) -> dict:
        """Snapshot the learned rates as a plain JSON-able dict, so a
        restarted service warm-starts its scheduler instead of relearning
        the fleet from the prior (``ERService.export_feedback_state``)."""
        return {
            "version": 1,
            "n_dev": self.n_dev,
            "alpha": self.alpha,
            "prior_rate": self.prior_rate,
            "observations": self.observations,
            "global": self._global,
            "dev": [None if math.isnan(v) else float(v)
                    for v in self._dev],
            "cls": [[None if math.isnan(v) else float(v) for v in row]
                    for row in self._cls],
        }

    @classmethod
    def from_state(cls, state: dict) -> "EwmaCostModel":
        """Rebuild a model from :meth:`to_state` output. Exact
        round-trip: ``from_state(m.to_state())`` predicts identically to
        ``m`` and keeps folding observations with the same alpha."""
        if state.get("version") != 1:
            raise ValueError(f"unknown EwmaCostModel state version: "
                             f"{state.get('version')!r}")
        m = cls(int(state["n_dev"]), alpha=float(state["alpha"]),
                prior_rate=float(state["prior_rate"]))
        m.observations = int(state["observations"])
        m._global = float(state["global"])
        m._dev = np.asarray(
            [np.nan if v is None else v for v in state["dev"]], np.float64)
        m._cls = np.asarray(
            [[np.nan if v is None else v for v in row]
             for row in state["cls"]], np.float64)
        if m._dev.shape != (m.n_dev,) or m._cls.shape != (m.n_dev,
                                                          N_TILE_CLASSES):
            raise ValueError("EwmaCostModel state shape mismatch")
        return m


class GeometryCostModel:
    """Geometry-keyed EWMA of measured seconds-per-live-pair, the online
    half of the tile-geometry autotuner (er/compiler/tune.py).

    A catalog's *live pair count* is geometry-invariant (it is the
    plan's pair total — only the dead padding around those pairs changes
    with (block_m, block_n)), so seconds-per-live-pair measured under
    different geometries rank the geometries directly: the one that
    wastes the least kernel time per useful pair wins. ``observe()`` folds
    one measured sweep leg or serving batch; ``rate()`` falls back to
    NaN for unmeasured geometries (the static occupancy model keeps
    ranking those); ``best()`` returns the measured argmin.
    """

    def __init__(self, alpha: float = 0.35):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = float(alpha)
        self.observations = 0
        self._rate: dict = {}          # (block_m, block_n) -> EWMA s/pair

    def observe(self, geometry, live_pairs: float, seconds: float) -> None:
        """Fold one measured stage-1 call at ``geometry`` over a catalog
        with ``live_pairs`` exact live pairs taking ``seconds`` wall."""
        key = (int(geometry[0]), int(geometry[1]))
        if live_pairs <= 0 or seconds < 0:
            return
        new = max(float(seconds), 1e-9) / float(live_pairs)
        old = self._rate.get(key)
        self._rate[key] = new if old is None else (
            (1.0 - self.alpha) * old + self.alpha * new)
        self.observations += 1

    def rate(self, geometry) -> float:
        """EWMA seconds per live pair at ``geometry``; NaN if unmeasured."""
        return self._rate.get((int(geometry[0]), int(geometry[1])),
                              float("nan"))

    def best(self, candidates=None):
        """Measured-best geometry among ``candidates`` (default: every
        measured geometry); None when nothing relevant is measured."""
        pool = (self._rate if candidates is None
                else {k: self._rate[k] for k in
                      ((int(g[0]), int(g[1])) for g in candidates)
                      if k in self._rate})
        if not pool:
            return None
        return min(pool, key=pool.get)

    def to_state(self) -> dict:
        """JSON-able snapshot (same restart story as
        :meth:`EwmaCostModel.to_state`)."""
        return {
            "version": 1,
            "alpha": self.alpha,
            "observations": self.observations,
            "rates": [[k[0], k[1], v] for k, v in sorted(self._rate.items())],
        }

    @classmethod
    def from_state(cls, state: dict) -> "GeometryCostModel":
        if state.get("version") != 1:
            raise ValueError(f"unknown GeometryCostModel state version: "
                             f"{state.get('version')!r}")
        m = cls(alpha=float(state["alpha"]))
        m.observations = int(state["observations"])
        m._rate = {(int(bm), int(bn)): float(v)
                   for bm, bn, v in state["rates"]}
        return m

"""Task -> reduce-task assignment (shared by BlockSplit and the MoE layer).

The paper's BlockSplit assigns match tasks with a greedy LPT heuristic:
sort tasks by pair count descending, then repeatedly give the next task to
the reduce task with the fewest assigned pairs (§IV, Alg. 1 lines 22-27).

Two twins, as ``repro.core.assignment``:
  * :func:`greedy_lpt` — numpy host planning (dynamic task count).
  * :func:`greedy_lpt_torch` — static shapes on any device, a running-load
    argmin per task (the reference's ``greedy_lpt_jnp``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["greedy_lpt", "greedy_lpt_hetero", "greedy_lpt_torch",
           "makespan_stats"]


def greedy_lpt(weights: np.ndarray, r: int) -> Tuple[np.ndarray, np.ndarray]:
    """Assign each weighted task to one of ``r`` bins, largest-first.

    Returns ``(assignment, loads)`` — assignment[t] in [0, r), loads (r,).
    Ties broken by lowest bin index (paper's getNextReduceTask).
    """
    w = np.asarray(weights, np.int64)
    order = np.argsort(-w, kind="stable")
    assignment = np.empty(w.shape[0], np.int64)
    loads = np.zeros(r, np.int64)
    for t in order:
        k = int(np.argmin(loads))
        assignment[t] = k
        loads[k] += w[t]
    return assignment, loads


def greedy_lpt_hetero(weights, rates) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """LPT over *heterogeneous* bins: assign each task (largest first) to
    the bin that would finish it earliest, ``(load_k + w) * rates[k]``.

    ``rates`` are per-bin seconds-per-unit-work (a slow device has a
    larger rate); with equal rates this degenerates to :func:`greedy_lpt`
    up to ties. Returns ``(assignment, loads, finish)`` — loads in work
    units, finish in seconds. Used by the runtime-feedback scheduler to
    place reducer loads onto EWMA-measured devices.
    """
    w = np.asarray(weights, np.float64)
    rates = np.maximum(np.asarray(rates, np.float64), 1e-300)
    order = np.argsort(-w, kind="stable")
    assignment = np.empty(w.shape[0], np.int64)
    loads = np.zeros(rates.shape[0], np.float64)
    for t in order:
        k = int(np.argmin((loads + w[t]) * rates))
        assignment[t] = k
        loads[k] += w[t]
    return assignment, loads, loads * rates


def greedy_lpt_torch(weights: torch.Tensor, r: int):
    """Torch twin of :func:`greedy_lpt` (the reference's ``greedy_lpt_jnp``):
    tasks in stable descending-weight order, each to the bin of least
    running load, the lowest bin on ties. Returns ``(assignment, loads)``
    on the device of ``weights``: assignment (T,) int64, loads (r,) in the
    weights' dtype. The loop runs T steps of device ops and reads nothing
    back to the host."""
    order = torch.argsort(-weights, stable=True)
    w_sorted = weights[order]
    loads = torch.zeros(r, dtype=weights.dtype, device=weights.device)
    bins = torch.empty_like(order)
    for i in range(order.shape[0]):
        k = torch.argmin(loads)      # first minimum: the lowest bin on ties
        loads.index_add_(0, k.view(1), w_sorted[i:i + 1])
        bins[i] = k
    assignment = torch.empty_like(order)
    assignment[order] = bins
    return assignment, loads


def makespan_stats(loads: np.ndarray) -> dict:
    """Balance metrics used across benchmarks (paper's implicit metric)."""
    loads = np.asarray(loads, np.float64)
    total = loads.sum()
    mean = total / loads.shape[0] if loads.shape[0] else 0.0
    mx = loads.max() if loads.size else 0.0
    return {
        "total": float(total),
        "mean": float(mean),
        "max": float(mx),
        "imbalance": float(mx / mean) if mean > 0 else 1.0,
        "idle_frac": float(1.0 - total / (mx * loads.shape[0])) if mx > 0 else 0.0,
    }

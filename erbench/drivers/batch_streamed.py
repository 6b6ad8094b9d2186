"""Batch traffic at a size whose pairs the host cannot hold: one-shot
``run_er`` back to back, as the ``batch`` driver runs it (its set-up,
window, spans and survivor log), held to the streamed reference
(``reference.streamed``).

The check differs from ``batch.judge`` in how it gets to the same
numbers. Each code row that stage 2 received is hashed once and the
survivors index the hashes, where ``check.survivor_hashes`` gathers one
64-byte row a survivor on the card (10.8 GB at DS2's 1.7·10⁸). The
survivor multisets are compared in torch on the cell's device, where
``check.multiset_diff`` takes ``np.unique`` with its inverse on the host
(an argsort: minutes at 3.4·10⁸ keys). :func:`window_numbers` gives
``check.batch_numbers``' numbers.
"""
from __future__ import annotations

import gc
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import check
from ..reference import streamed
from .batch import (rows_touched, setup, span_targets,  # noqa: F401
                    survivor_modules, window)


def survivor_hashes(calls: Sequence[Tuple]) -> Tuple[np.ndarray, np.ndarray]:
    """``check.survivor_hashes`` of the logged calls: each distinct code
    tensor is hashed once, and the survivors index its hashes."""
    hashed: Dict[int, np.ndarray] = {}
    ha, hb = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for codes_a, codes_b, rows_a, rows_b in calls:
        ra = np.asarray(rows_a, np.int64)
        if not ra.size:
            continue
        for codes, rows, out in ((codes_a, ra, ha),
                                 (codes_b, np.asarray(rows_b, np.int64), hb)):
            if id(codes) not in hashed:
                hashed[id(codes)] = check.row_hash(codes)
            out.append(hashed[id(codes)][rows])
    return np.concatenate(ha), np.concatenate(hb)


def multiset_diff(got: np.ndarray, want: np.ndarray, skip: np.ndarray,
                  device) -> int:
    """``check.multiset_diff`` in torch on ``device``: Σ |count in got −
    count in want| over keys not in ``skip``."""
    g = torch.as_tensor(got, device=device)
    keys, inv = torch.unique(torch.cat([g, torch.as_tensor(
        want, device=device)]), return_inverse=True)
    diff = (torch.bincount(inv[:g.numel()], minlength=keys.numel())
            - torch.bincount(inv[g.numel():], minlength=keys.numel())).abs()
    keep = ~torch.isin(keys, torch.as_tensor(skip, device=device))
    return int(diff[keep].sum())


def window_numbers(runs: List[Dict], want: Dict, device) -> Dict[str, float]:
    """``check.batch_numbers`` of runs that carry ``survivor_keys``
    (``check.pair_keys`` of their survivors) rather than the hashes, with
    the survivor multisets compared on ``device``."""
    surv, match = 0, 0
    for run in runs:
        if run.get("error"):
            continue
        surv = max(surv, multiset_diff(run["survivor_keys"],
                                       want["survivors"], want["band_keys"],
                                       device))
        match = max(match, check.set_diff(run["matches"], want["matches"],
                                          want["band_pairs"]))
    return {"survivor_diff": surv, "match_diff": match,
            "failed": sum(1 for r in runs if r.get("error"))}


def judge(state, record, cell):
    """Key every run's survivors, free the program's state, then hold
    each run to the streamed reference."""
    for run in record["runs"]:
        run["survivor_keys"] = streamed.pair_keys(
            *survivor_hashes(run.pop("calls")), cell.device)
    record["survivors"] = sum(r["survivor_keys"].size
                              for r in record["runs"])
    record["rows_touched"] = rows_touched(state["titles"], state["er"]) * \
        sum(1 for r in record["runs"] if "error" not in r)
    titles, er = state["titles"], state["er"]
    state.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    want = streamed.batch_expected(titles, er,
                                   er.get("strategy", "pair_range"),
                                   cell.device)
    return window_numbers(record["runs"], want, cell.device)

"""Tile-geometry autotuning on the port: lattice sweep + occupancy model
vs measured stage-1 throughput on the Fig. 9 skew workload (torch leg of
``tune_bench``).

Two legs at the paper's robustness point s = 1.0:
  * **lattice sweep** — the BlockSplit job lowered once per geometry
    ``autotune`` keeps, each catalog scored on the same features (K1 at
    every geometry on the card); every geometry must give the 128x128
    match set. Per geometry the model's columns (tiles, occupancy, waste,
    model cost) and the match count equal the JAX leg's, as does the
    model's static pick. The wall of ``score_catalog`` (``seconds``, as
    in the JAX leg) feeds a :class:`GeometryCostModel` and a feedback
    ``autotune`` refit.
  * **service leg** — an :class:`ERService` with ``autotune_tiles=True``
    sweeps its lattice in ``warmup()`` and then serves with no kernel
    build or load (``compile_counter``).

Asserted in :func:`measure` (exact): match-set equality across the
lattice, 0 steady-state builds after the autotuning warmup. Asserted in
:func:`check` (wall-time bars): the autotuned geometry is >=
``SPEEDUP_BAR`` x the fixed 128x128 stage-1 throughput, and the feedback
refit picks the measured-fastest geometry.

    PYTHONPATH=src python -m benchmarks.torch_tune_bench [--quick] [--device cpu|cuda]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import compute_bdm, plan_block_split
from repro_torch.device import resolve_device
from repro_torch.er import ERService, ServiceConfig, compile_counter
from repro_torch.er.blocking import exponential_block_ids
from repro_torch.er.compiler import (GeometryCostModel, autotune, lower,
                                     plan_to_job, score_catalog)

from .common import print_table, save_rows, timer
from .torch_common import cli, count_view, impl_of
from .torch_serve_bench import skewed_corpus

SPEEDUP_BAR = 1.2          # autotuned vs fixed 128x128, stage-1 pairs/s
BASELINE = (128, 128)
# The columns that equal the JAX leg's per geometry, and the model's
# static pick; the measured and feedback picks and the service's pinned
# geometry are clocks.
COUNTS = ("geometry", "tiles", "occupancy", "waste_cells", "model_cost",
          "matches", "autotuned")


def _skew_workload(n: int, d: int, r: int, m: int, s: float, seed: int = 7):
    rng = np.random.default_rng(seed)
    bid = exponential_block_ids(n, b=100, s=s, rng=rng)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    order = np.argsort(bid, kind="stable")
    feats, bid = feats[order], bid[order]
    sizes = np.bincount(bid)
    part = np.arange(n, dtype=np.int64) % m
    bdm = compute_bdm(bid, part, int(sizes.shape[0]), m)
    return feats, plan_to_job(plan_block_split(bdm, r))


def _bench_geometry(feats, job, bm, bn, threshold, impl, dev, repeats=2):
    """(wall seconds of ``score_catalog``, match set) at one geometry,
    from the fastest of ``repeats`` calls."""
    cat = lower(job, bm, bn)
    score_catalog(feats, cat, threshold=threshold, impl=impl, device=dev)
    best = float("inf")
    for _ in range(repeats):
        with timer() as t:
            ra, rb = score_catalog(feats, cat, threshold=threshold,
                                   impl=impl, device=dev)
        best = min(best, t.seconds)
    matches = {(min(a, b), max(a, b)) for a, b in zip(ra.tolist(), rb.tolist())}
    return best, matches


def measure(n: int = 8_000, d: int = 256, r: int = 100, m: int = 20,
            svc_n: int = 4_000, quick: bool = False, device="cuda"):
    dev = resolve_device(device)
    impl = impl_of(dev)
    if quick:
        n, svc_n = 3_000, 2_000
    threshold = 0.15
    feats, job = _skew_workload(n, d, r, m, s=1.0)
    feats_dev = torch.from_numpy(feats).to(dev)

    # ---- leg 1: lattice sweep, match-set parity ----
    report = autotune(job, d=d)           # static occupancy/waste ranking
    feedback = GeometryCostModel()
    rows, match_sets, seconds = [], {}, {}
    for sc in report.scores:
        secs, matches = _bench_geometry(
            feats_dev, job, sc.block_m, sc.block_n, threshold, impl, dev)
        seconds[sc.geometry] = secs
        match_sets[sc.geometry] = matches
        feedback.observe(sc.geometry, sc.live_pairs, secs)
        rows.append({
            "geometry": f"{sc.block_m}x{sc.block_n}",
            "tiles": sc.tiles,
            "occupancy": round(sc.occupancy, 3),
            "waste_cells": sc.waste,
            "model_cost": round(sc.model_cost, 0),
            "seconds": round(secs, 4),
            "mpairs_per_s": round(sc.live_pairs / secs / 1e6, 2),
            "matches": len(matches),
        })
    base_set = match_sets[BASELINE]
    for geom, matches in match_sets.items():
        assert matches == base_set, \
            f"geometry {geom} changed the match set vs {BASELINE}"

    tuned = report.geometry
    speedup = seconds[BASELINE] / seconds[tuned]
    refit = autotune(job, d=d, feedback=feedback)
    measured_best = min(seconds, key=seconds.get)
    rows.sort(key=lambda r: r["seconds"])
    meta = {
        "n": n, "d": d, "skew_s": 1.0, "impl": impl,
        "autotuned": f"{tuned[0]}x{tuned[1]}",
        "speedup_vs_128": round(speedup, 2),
        "feedback_pick": f"{refit.geometry[0]}x{refit.geometry[1]}",
        "measured_best": f"{measured_best[0]}x{measured_best[1]}",
    }
    print_table(f"tune_bench — lattice sweep on {dev}, Fig. 9 skew s=1.0 "
                f"(n={n}, d={d}, impl={impl})", rows)
    print("meta:", meta)

    # ---- leg 2: service autotune warmup, zero steady builds ----
    titles, rng = skewed_corpus(svc_n, b=100, s=1.0)
    lattice = ((32, 32), (64, 64), (128, 128))
    cfg = ServiceConfig(feature_dim=128, max_len=48, r=32, m=8,
                        query_buckets=(8, 32), tile_chunk=256,
                        autotune_tiles=True, autotune_lattice=lattice,
                        kernel_impl=impl)
    svc = ERService(titles, cfg, device=dev)
    with compile_counter() as warm, timer() as t_warm:
        svc.warmup()
    with compile_counter() as steady, timer() as t_steady:
        nq = 0
        for _ in range(8):
            qs = [titles[int(rng.integers(0, len(titles)))] for _ in range(8)]
            svc.match(qs)
            nq += len(qs)
    svc_row = {
        "geometry": f"{svc.tile_geometry[0]}x{svc.tile_geometry[1]}",
        "lattice": len(lattice),
        "warmup_s": round(t_warm.seconds, 2),
        "warmup_compiles": warm.count,
        "steady_compiles": steady.count,
        "queries_per_s": round(nq / max(t_steady.seconds, 1e-9), 1),
    }
    print_table(f"tune_bench — ERService autotune warmup (n={svc_n})",
                [svc_row])
    rows = [dict(r, **meta) for r in rows] + [dict(svc_row, leg="service")]
    save_rows("torch_tune_bench", rows)
    assert steady.count == 0, \
        f"steady-state builds after autotuning warmup: {steady.count}"
    return rows


def counts(rows):
    """The lattice rows' count columns in geometry order (the rows are
    sorted by measured seconds)."""
    return count_view([r for r in rows if r.get("leg") != "service"],
                      COUNTS, order="geometry")


def check(rows):
    """The wall-time bars: the static pick's speedup over 128x128, and
    the feedback refit's pick equal to the measured best."""
    meta = rows[0]
    assert meta["speedup_vs_128"] >= SPEEDUP_BAR, \
        f"autotuned {meta['autotuned']} only {meta['speedup_vs_128']}x vs " \
        f"fixed 128x128 (bar {SPEEDUP_BAR}x)"
    assert meta["feedback_pick"] == meta["measured_best"], \
        f"feedback autotune picked {meta['feedback_pick']}, " \
        f"measured best was {meta['measured_best']}"


def run(n: int = 8_000, quick: bool = False, device="cuda"):
    rows = measure(n, quick=quick, device=device)
    check(rows)
    return rows


if __name__ == "__main__":
    raise SystemExit(cli(run, __doc__))

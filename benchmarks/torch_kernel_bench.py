"""Kernel micro-benchmarks on the port: the pair-similarity hot spot
(torch leg of ``kernel_bench``).

Two suites, as the JAX leg's:
  * :func:`run` — the dense ``ops.pair_scores`` (K5) at the JAX leg's
    shapes and tiles, triangular, threshold 0.8, in f32 (the JAX leg's
    columns; on the card the FMA kernel) and, in ``bf16_*`` columns, on
    the same inputs in bf16 (on the card the wgmma + TMA kernel);
    ``vmem_per_step_kib`` keeps the JAX leg's per-step tile bytes.
  * :func:`run_catalog` — the tile-catalog executor (``build_catalog`` +
    ``score_catalog``: K1, K2 on overflow) against the numpy stage 1 it
    replaced (per-reducer pair lists + chunked ``np.einsum``), at the
    paper's Fig. 9 skew s = 1.0. The survivor sets must be equal: a pair
    that only one side keeps must score within ``NEAR`` of the threshold
    (f32 rounding), and is printed and counted (``near_flips``). On the
    card the catalog executor must win by >= 5x (``check_catalog``).

Unlike the JAX leg, this leg writes no ``BENCH_pair_sim.json``: only
``benchmarks/out/torch_kernel_bench{,_catalog}.json``.

    PYTHONPATH=src python -m benchmarks.torch_kernel_bench [--quick] [--device cpu|cuda]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import ops

from .common import print_table, save_rows
from .torch_common import cli, count_view, impl_of

_CHUNK = 65_536
NEAR = 1e-6                 # a flip is allowed only this close to the threshold
CATALOG_SPEEDUP_BAR = 5.0   # catalog executor vs numpy stage 1, on the card
# The columns that equal the JAX leg's row for row (the rest are clocks);
# the survivors may differ by the near-threshold flips each side counted.
COUNTS = ("kernel", "n", "d", "tile", "vmem_per_step_kib")
CATALOG_COUNTS = ("strategy", "n", "pairs", "tiles", "survivors")
NEAR_COLUMNS = {"survivors": "near_flips"}


def _bench(fn, dev, iters=3):
    fn()
    synchronize([dev])
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    synchronize([dev])
    return (time.perf_counter() - t0) / iters


def measure(quick: bool = False, device="cuda"):
    dev = resolve_device(device)
    impl = impl_of(dev)
    rng = np.random.default_rng(0)
    rows = []
    sizes = [(1024, 256), (4096, 256)] if not quick else [(1024, 256)]
    for n, d in sizes:
        a = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
        a16 = a.to(torch.bfloat16)
        for bm in (128, 256):
            vmem = (bm * d + bm * d + bm * bm) * 4
            t = _bench(lambda x=a, bm=bm: ops.pair_scores(
                x, x, threshold=0.8, triangular=True, block_m=bm, block_n=bm,
                impl=impl), dev)
            t16 = _bench(lambda x=a16, bm=bm: ops.pair_scores(
                x, x, threshold=0.8, triangular=True, block_m=bm, block_n=bm,
                impl=impl), dev)
            pairs = n * (n - 1) / 2
            rows.append({
                "kernel": "pair_sim", "n": n, "d": d, "tile": f"{bm}x{bm}",
                "vmem_per_step_kib": vmem // 1024,
                "xla_ref_s": round(t, 4),
                "gpairs_per_s(xla)": round(pairs / t / 1e9, 3),
                "impl": impl,
                "bf16_s": round(t16, 4),
                "gpairs_per_s(bf16)": round(pairs / t16 / 1e9, 3),
            })
    print_table(f"kernel bench — dense pair_scores on {dev} (impl={impl}; "
                f"xla_* columns: f32, as the JAX leg)", rows)
    save_rows("torch_kernel_bench", rows)
    return rows


def counts(rows):
    """The dense rows' count columns, in row order."""
    return count_view(rows, COUNTS)


def catalog_counts(rows):
    """The catalog rows' count columns, in row order."""
    return count_view(rows, CATALOG_COUNTS)


def check(rows):
    """No bar on the dense suite (as the JAX leg)."""


def run(quick: bool = False, device="cuda"):
    rows = measure(quick=quick, device=device)
    check(rows)
    return rows


# ---------------------------------------------------------------------------
# Tile-catalog executor vs reference numpy stage-1 (Fig. 9 skew=1.0)
# ---------------------------------------------------------------------------

def _stage1_numpy(feats, plan, strategy, estart, sizes, threshold):
    """The replaced hot path: materialize each reduce task's pair list,
    filter with chunked paired-dot einsum. Returns the survivor arrays."""
    from repro_torch.core import pairs_of_range
    from repro_torch.er.compiler import enumerate_task_pairs as _tile_pairs

    cand_a, cand_b = [], []

    def filt(ra, rb):
        for lo in range(0, ra.shape[0], _CHUNK):
            a = ra[lo:lo + _CHUNK]
            b = rb[lo:lo + _CHUNK]
            cos = np.einsum("pd,pd->p", feats[a], feats[b])
            sel = np.flatnonzero(cos >= threshold)
            cand_a.append(a[sel])
            cand_b.append(b[sel])

    if strategy == "pair_range":
        for k in range(plan.r):
            _, _, _, ra, rb = pairs_of_range(plan, k)
            filt(ra, rb)
    elif strategy == "block_split":
        for t in range(plan.task_block.shape[0]):
            ra, rb = _tile_pairs(
                int(plan.task_a_start[t]), int(plan.task_a_len[t]),
                int(plan.task_b_start[t]), int(plan.task_b_len[t]),
                bool(plan.task_triangular[t]))
            filt(ra, rb)
    else:  # basic
        for k in np.flatnonzero(sizes >= 2):
            ra, rb = _tile_pairs(int(estart[k]), int(sizes[k]), 0, 0, True)
            filt(ra, rb)
    ca = np.concatenate(cand_a) if cand_a else np.zeros(0, np.int64)
    cb = np.concatenate(cand_b) if cand_b else np.zeros(0, np.int64)
    return ca, cb


def near_flips(got: set, want: set, feats, threshold: float):
    """The pairs only one side keeps, each with its f64 score; raises
    unless every one scores within ``NEAR`` of the threshold."""
    flips = []
    for a, b in sorted(got ^ want):
        score = float(np.dot(feats[a].astype(np.float64),
                             feats[b].astype(np.float64)))
        flips.append((a, b, score))
        print(f"near-threshold flip: pair ({a}, {b}) score {score!r} "
              f"(threshold {threshold}, kept by "
              f"{'the kernel' if (a, b) in got else 'numpy'})")
    far = [f for f in flips if abs(f[2] - threshold) > NEAR]
    assert not far, f"survivor sets differ away from the threshold: {far}"
    return flips


def measure_catalog(quick: bool = False, device="cuda"):
    from repro_torch.core import (compute_bdm, plan_basic, plan_block_split,
                                  plan_pair_range)
    from repro_torch.er.blocking import exponential_block_ids
    from repro_torch.er.executor import build_catalog, score_catalog

    dev = resolve_device(device)
    impl = impl_of(dev)
    n = 3_000 if quick else 8_000
    d, r, m = 256, 100, 20
    s = 1.0                          # Fig. 9's hardest skew point
    threshold = 0.15                 # ~2.4 sigma: ~1% survivors

    rng = np.random.default_rng(7)
    bid = exponential_block_ids(n, b=100, s=s, rng=rng)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)

    # Blocked layout: stable sort by block id; partitions round-robin.
    order = np.argsort(bid, kind="stable")
    feats = feats[order]
    bid_sorted = bid[order]
    sizes = np.bincount(bid_sorted)
    estart = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    part = np.arange(n, dtype=np.int64) % m
    bdm = compute_bdm(bid_sorted, part, int(sizes.shape[0]), m)
    feats_dev = torch.from_numpy(feats).to(dev)

    rows = []
    strategies = ("block_split",) if quick else (
        "basic", "block_split", "pair_range")
    for strategy in strategies:
        plan = {"basic": plan_basic, "block_split": plan_block_split,
                "pair_range": plan_pair_range}[strategy](bdm, r)
        total = plan.total_pairs

        t0 = time.perf_counter()
        na, nb = _stage1_numpy(feats, plan, strategy, estart, sizes,
                               threshold)
        t_numpy = time.perf_counter() - t0

        # warm once (the kernel library's load), then time plan-compile +
        # execution — the catalog build is part of the executor's work.
        cat = build_catalog(plan)
        score_catalog(feats_dev, cat, threshold=threshold, impl=impl,
                      device=dev)
        t0 = time.perf_counter()
        cat = build_catalog(plan)
        ca, cb = score_catalog(feats_dev, cat, threshold=threshold,
                               impl=impl, device=dev)
        t_catalog = time.perf_counter() - t0

        norm = {(min(a, b), max(a, b)) for a, b in zip(na.tolist(),
                                                       nb.tolist())}
        got = {(min(a, b), max(a, b)) for a, b in zip(ca.tolist(),
                                                      cb.tolist())}
        flips = near_flips(got, norm, feats, threshold)

        speedup = t_numpy / max(t_catalog, 1e-9)
        rows.append({
            "strategy": strategy, "n": n, "pairs": int(total),
            "tiles": cat.num_tiles, "survivors": len(got),
            "numpy_s": round(t_numpy, 4), "catalog_s": round(t_catalog, 4),
            "mpairs_per_s(numpy)": round(total / t_numpy / 1e6, 1),
            "mpairs_per_s(catalog)": round(total / t_catalog / 1e6, 1),
            "speedup": round(speedup, 2),
            "impl": impl, "near_flips": len(flips),
        })
    print_table(f"tile-catalog executor vs numpy stage-1 "
                f"(Fig. 9 skew={s}, device={dev}, impl={impl})", rows)
    save_rows("torch_kernel_bench_catalog", rows)
    return rows


def check_catalog(rows):
    """The JAX leg's accelerator bar: on the card the catalog executor
    wins by >= 5x over the numpy stage 1 (the CPU route is exempt, as the
    JAX leg's CPU backends are)."""
    if all(row["impl"] == "cuda" for row in rows):
        worst = min(row["speedup"] for row in rows)
        assert worst >= CATALOG_SPEEDUP_BAR, \
            f"catalog executor speedup {worst} < {CATALOG_SPEEDUP_BAR}x"


def run_catalog(quick: bool = False, device="cuda"):
    rows = measure_catalog(quick=quick, device=device)
    check_catalog(rows)
    return rows


def _main(quick: bool = False, device="cuda"):
    run(quick=quick, device=device)
    run_catalog(quick=quick, device=device)


if __name__ == "__main__":
    raise SystemExit(cli(_main, __doc__))

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device  — the card's name, the device count, its power limit;
  2. build   — the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, one
               process per source, all at once), with the build seconds and
               what ``-Xptxas -v`` reports per kernel;
  3. kernels — each CUDA kernel against its plain PyTorch version on
               catalogs from real plans (all four strategies, the match_⊥
               cross job, zero pad rows) over several geometries, widths,
               dtypes and capacities;
  4. DS1     — ``run_er`` at the paper's DS1 size for every strategy, on
               the catalog executor and on the reference executor;
  5. overflow — DS1 PairRange with a 16-slot capacity, so chunks overflow
               and re-score through the dense-mask kernel;
  6. timing  — on the first 1024-tile chunk of the DS1 PairRange catalog
               (the main path's shapes): both kernels against their plain
               versions, then CUDA-event times of both, of the plain
               versions and of a library yardstick, beside the card's
               bound for the same work.

The last two lines of standard output are the kernel summary and
``{"ok": true, "device": {...}}``. Without a card, or without the repo
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

DS1_N = 114_000
DS1_PAIR_RANGE = {"total_pairs": 2_981_848, "catalog_tiles": 29_722,
                  "compact_decodes": 30, "matches": 7_788}
STRATEGIES = ("basic", "block_split", "pair_range", "sorted_neighborhood")
NEAR = 1e-6            # a kernel/plain disagreement is allowed only on cells
                       # whose f64 score lies within NEAR of the threshold
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3


def log(*args):
    print(*args, flush=True)


def phase(name):
    log(f"\n=== {name} ===")


# ---------------------------------------------------------------------------
# 1-2: device and build
# ---------------------------------------------------------------------------

def device_phase(torch):
    phase("1 device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}  count: {count}")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"python {sys.version.split()[0]}")
    return name, count, smi


def build_phase():
    from repro_torch.kernels import build, pair_sim
    phase("2 build")
    t0 = time.perf_counter()
    build.build_all()
    seconds = time.perf_counter() - t0
    log(f"nvcc {' '.join(build.NVCC_FLAGS)}")
    for name, entry in build.BUILD_LOG.items():
        if entry["cached"]:
            log(f"{name}: loaded from {build.BUILD_DIR} without compiling "
                f"(cached); ptxas report from its build")
        else:
            log(f"{name}: built in {entry['seconds']:.1f} s")
        if not entry["log"].strip():
            raise AssertionError(f"{name}: no ptxas report")
        blocks = re.findall(
            r"Function properties for (\S+)\n\s+(\d+) bytes stack frame, "
            r"(\d+) bytes spill stores, (\d+) bytes spill loads\n"
            r"ptxas info\s+: Used (\d+) registers.*?(\d+) bytes smem",
            entry["log"])
        for fn, stack, st, ld, regs, smem in blocks:
            m = re.search(r"catalog_kernelI(\w+?)Li(\d+)ELi(\d+)ELb(\d)", fn)
            label = (f"{'compact' if m.group(4) == '1' else 'mask'} "
                     f"{'bf16' if 'bfloat16' in m.group(1) else 'f32'} "
                     f"{m.group(2)}x{m.group(3)}") if m else fn
            bm_bn = (int(m.group(2)), int(m.group(3))) if m else None
            dyn = (pair_sim.catalog_smem_bytes(*bm_bn) if bm_bn else 0)
            log(f"  {name}: {label:<22} regs {regs:>3}  spill st/ld "
                f"{st}/{ld} B  stack {stack} B  static smem {smem} B  "
                f"dynamic smem {dyn} B")
    lib = pair_sim._lib()
    for bm, bn in pair_sim.GEOMETRY_LATTICE:
        got = lib.pair_sim_smem_bytes(bm, bn)
        if got != pair_sim.catalog_smem_bytes(bm, bn):
            raise AssertionError(f"shared-memory model disagrees with the "
                                 f"kernel at ({bm}, {bn}): {got}")
    log("shared-memory model agrees with the kernel on the whole lattice")
    return seconds


# ---------------------------------------------------------------------------
# 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _plans(n_titles, seed):
    """Real plans of every strategy (+ the match_⊥ cross job) on a
    generated corpus, as ``run_er`` makes them: name -> (job, row order)."""
    import numpy as np
    from repro_torch.er import ERConfig, make_products, plan_job
    from repro_torch.er.compiler import cross_job, plan_to_job

    ds = make_products(n_titles, seed=seed)
    jobs = {}
    for strategy in STRATEGIES:
        jp = plan_job(ds.titles, ERConfig(strategy=strategy))
        jobs[strategy] = (plan_to_job(jp.plan), jp.to_global)
    # run_er scores the cross job on the features in input order
    jobs["cross"] = (cross_job(len(ds.titles), 300, 32),
                     np.arange(len(ds.titles)))
    return ds, jobs


def _near_threshold(a, b, tiles, diff, bm, bn, thr):
    """True iff every differing cell's f64 score lies within NEAR of thr."""
    t, i, j = diff.nonzero(as_tuple=True)
    rows = tiles[t, 0].long() * bm + i
    cols = tiles[t, 1].long() * bn + j
    s = (a[rows].double() * b[cols].double()).sum(dim=1)
    return bool(((s - thr).abs() <= NEAR).all()), int(t.numel())


def new_stats():
    """Per-kernel tallies of the kernel-vs-plain comparisons."""
    return {k: {"cases": 0, "near_flips": 0, "max_abs_err": 0.0}
            for k in ("pair_scores_catalog", "pair_scores_catalog_compact")}


def compare(torch, fa, b, cat, bm, bn, thr, capacities, stats, label):
    """Hold the mask kernel and the compact kernel (at each capacity)
    against their plain versions on one catalog. A cell may differ only
    where its f64 score lies within NEAR of the threshold; anything else
    raises. ``max_abs_err`` is the largest |kernel − plain| over every
    output element, flips included."""
    from repro_torch.kernels import ops, ref

    kw = dict(threshold=thr, block_m=bm, block_n=bn)
    mask_k = ops.pair_scores_catalog(fa, b, cat, impl="cuda", **kw)
    mask_p = ops.pair_scores_catalog(fa, b, cat, impl="torch", **kw)
    diff = mask_k != mask_p
    flips = 0
    if diff.any():
        ok, flips = _near_threshold(fa, b, cat, diff, bm, bn, thr)
        if not ok:
            raise AssertionError(
                f"mask kernel disagrees off the threshold: {label}")
    zero = cat[:, 2] == cat[:, 3]
    if bool(mask_k[zero].any()):
        raise AssertionError(f"zero pad rows kept a cell: {label}")
    st = stats["pair_scores_catalog"]
    st["max_abs_err"] = max(st["max_abs_err"],
                            (mask_k - mask_p).abs().max().item())
    st["near_flips"] += flips
    st["cases"] += 1
    same = ~diff.flatten(1).any(dim=1)
    for cap in capacities:
        packed, counts = ops.pair_scores_catalog_compact(
            fa, b, cat, capacity=cap, impl="cuda", **kw)
        plain_p, plain_c = ops.pair_scores_catalog_compact(
            fa, b, cat, capacity=cap, impl="torch", **kw)
        # Same keep set as the mask kernel (one mainloop), so the packed
        # output must equal the plain pack of the kernel's own mask, bit
        # for bit; on tiles where the masks agree it equals the plain
        # version's too.
        want_p, want_c = ref.pack_survivor_mask(mask_k, cap)
        if not (torch.equal(packed, want_p) and torch.equal(counts, want_c)
                and torch.equal(packed[same], plain_p[same])
                and torch.equal(counts[same], plain_c[same])):
            raise AssertionError(
                f"compact kernel disagrees: {label} capacity {cap}")
        st = stats["pair_scores_catalog_compact"]
        st["max_abs_err"] = max(
            st["max_abs_err"], (packed - plain_p).abs().max().item(),
            (counts - plain_c).abs().max().item())
        st["near_flips"] += flips
        st["cases"] += 1


def kernel_phase(torch, np, stats):
    from repro_torch.er.compiler import lower
    from repro_torch.er.encode import ngram_features

    phase("3 kernels vs plain versions")
    thr = float(np.float32(0.8 - 0.25))
    ds, jobs = _plans(20_000, seed=1)
    rng = np.random.default_rng(0)
    null = torch.from_numpy(rng.choice(len(ds.titles), 300,
                                       replace=False)).cuda()
    t0 = time.perf_counter()
    for d in (256, 128, 200):
        feats = torch.from_numpy(ngram_features(ds.titles, dim=d)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            full = feats.to(dtype)
            rows = {name: full[torch.from_numpy(order).cuda()].contiguous()
                    for name, (_, order) in jobs.items()}
            fq = full[null].contiguous()
            for bm, bn in ((128, 128), (64, 128), (256, 256), (32, 32)):
                for name, (job, _) in jobs.items():
                    tiles = lower(job, bm, bn).tiles
                    if tiles.shape[0] > 512:
                        tiles = tiles[rng.choice(tiles.shape[0], 512,
                                                 replace=False)]
                    tiles = np.concatenate(
                        [tiles, np.zeros((7, tiles.shape[1]), np.int32)])
                    fa = rows[name]
                    compare(torch, fa, fq if name == "cross" else fa,
                            torch.from_numpy(tiles).cuda(), bm, bn, thr,
                            (bm * bn, 32, 4), stats,
                            f"{name} d={d} {dtype} ({bm},{bn})")
    torch.cuda.synchronize()
    log(f"{stats['pair_scores_catalog_compact']['cases']} compact cases + "
        f"{stats['pair_scores_catalog']['cases']} mask cases equal to the "
        f"plain versions (d in 256/128/200, f32 and bf16, geometries "
        f"128x128 64x128 256x256 32x32, capacities bm*bn/32/4, 4 strategies "
        f"+ cross + 7 zero rows); cells within {NEAR} of the threshold that "
        f"flipped: {stats['pair_scores_catalog']['near_flips']}; "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 4-5: the main path at DS1
# ---------------------------------------------------------------------------

def ds1_phase(torch):
    from repro_torch.er import ERConfig, make_products, run_er, stage1_stats
    from repro_torch.kernels import ops

    phase(f"4 main path: run_er at DS1 (make_products({DS1_N}, seed=0), "
          f"ERConfig() defaults, device='cuda')")
    ds = make_products(DS1_N, seed=0)
    truth = ds.true_pairs
    launches = {}
    rows = {}
    for strategy in STRATEGIES:
        before = dict(stage1_stats)
        ops.reset_launch_counts()
        res = run_er(ds.titles, ERConfig(strategy=strategy), device="cuda")
        counts = ops.launch_counts()
        s1 = {k: stage1_stats[k] - before[k] for k in stage1_stats}
        ref_res = run_er(ds.titles,
                         ERConfig(strategy=strategy, executor="reference"),
                         device="cuda")
        if res.matches != ref_res.matches:
            raise AssertionError(
                f"{strategy}: catalog and reference match sets differ "
                f"({len(res.matches)} vs {len(ref_res.matches)})")
        if counts["pair_scores_catalog_compact"] == 0:
            raise AssertionError(f"{strategy}: compact kernel not launched")
        recall = len(res.matches & truth) / max(len(truth), 1)
        tm = res.extra["timings"]
        log(f"[{strategy}] tiles {res.extra['catalog_tiles']}  planned pairs "
            f"{res.total_pairs}  survivors {res.extra['candidates']}  "
            f"matches {len(res.matches)} (reference {len(ref_res.matches)}, "
            f"equal)  recall {recall:.4f}")
        log(f"[{strategy}] launches {counts}  stage1_stats {s1}")
        log(f"[{strategy}] seconds: featurize {tm['featurize_s']:.3f}  "
            f"job1 {tm['job1_s']:.3f}  plan/lower/schedule {tm['plan_s']:.3f}"
            f"  upload {tm['upload_s']:.3f}  stage-1 kernel "
            f"{tm['stage1_s']:.3f}  decode {tm['decode_s']:.3f}  stage 2 "
            f"{tm['stage2_s']:.3f}  total {tm['total_s']:.3f}  "
            f"(reference executor total "
            f"{ref_res.extra['timings']['total_s']:.3f})")
        rows[strategy] = (res, s1)
        if strategy == "pair_range":
            launches.update(counts)
            got = {"total_pairs": res.total_pairs,
                   "catalog_tiles": res.extra["catalog_tiles"],
                   "compact_decodes": s1["compact_decodes"],
                   "matches": len(res.matches)}
            if got != DS1_PAIR_RANGE:
                raise AssertionError(f"pair_range at DS1: {got} != "
                                     f"{DS1_PAIR_RANGE}")
            log(f"[pair_range] counts as the JAX package gives them: {got}")
    return ds, rows, launches


def overflow_phase(ds):
    from repro_torch.er import ERConfig, run_er, stage1_stats
    from repro_torch.kernels import ops

    phase("5 overflow: pair_range at DS1 with compact_capacity=16")
    before = dict(stage1_stats)
    ops.reset_launch_counts()
    res = run_er(ds.titles, ERConfig(compact_capacity=16), device="cuda")
    counts = ops.launch_counts()
    s1 = {k: stage1_stats[k] - before[k] for k in stage1_stats}
    log(f"launches {counts}  stage1_stats {s1}  matches {len(res.matches)}")
    if not (s1["compact_overflows"] > 0
            and counts["pair_scores_catalog"] > 0
            and len(res.matches) == DS1_PAIR_RANGE["matches"]):
        raise AssertionError("overflow did not reach the mask kernel with "
                             "the same matches")
    return counts


# ---------------------------------------------------------------------------
# 6: timing
# ---------------------------------------------------------------------------

def _time_ms(torch, fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timing_phase(torch, np, ds, stats):
    from repro_torch.er import ERConfig, compile_catalog, featurize, plan_job
    from repro_torch.kernels import ops, ref

    phase("6 timing: one 1024-tile chunk of the DS1 pair_range catalog")
    cfg = ERConfig()
    _, _, feats = featurize(ds.titles, cfg)
    jp = plan_job(ds.titles, cfg)
    cat, _ = compile_catalog(jp.plan, cfg)
    tiles = cat.tiles[:1024]            # score_catalog's first chunk
    n = len(ds.titles)
    bm, bn, d = cat.block_m, cat.block_n, feats.shape[1]
    fa = torch.from_numpy(feats[jp.to_global]).cuda()
    ct = torch.from_numpy(np.ascontiguousarray(tiles)).cuda()
    thr = cfg.threshold - cfg.filter_margin
    kw = dict(threshold=thr, block_m=bm, block_n=bn)
    cap = bm * bn
    chunk = new_stats()
    compare(torch, fa, fa, ct, bm, bn, thr, (cap, 16), chunk,
            "DS1 pair_range chunk 0")
    for k, st in chunk.items():
        log(f"DS1 chunk, {k}: {st['cases']} case(s) equal to the plain "
            f"version (capacities {cap} and 16 for the compact kernel); "
            f"max_abs_err {st['max_abs_err']}; cells within {NEAR} of the "
            f"threshold that flipped: {st['near_flips']}")
        stats[k]["cases"] += st["cases"]
        stats[k]["near_flips"] += st["near_flips"]
        stats[k]["max_abs_err"] = max(stats[k]["max_abs_err"],
                                      st["max_abs_err"])
    live = int(((tiles[:, 2] < tiles[:, 3]) & (tiles[:, 4] < tiles[:, 5]))
               .sum())
    strip_rows = (np.unique(tiles[:, 0]).size * bm
                  + np.unique(tiles[:, 1]).size * bn)
    rows_read = len(set(np.concatenate(
        [np.unique(tiles[:, 0])[:, None] * bm + np.arange(bm),
         np.unique(tiles[:, 1])[:, None] * bn + np.arange(bn)]).ravel()
        .tolist()) & set(range(n)))
    in_bytes = rows_read * d * 4 + tiles.nbytes
    flops = 2.0 * bm * bn * d * live
    log(f"chunk: {tiles.shape[0]} tiles ({live} live) of {bm}x{bn}, d={d}, "
        f"f32; {strip_rows} strip rows named, {rows_read} distinct feature rows "
        f"read; {flops / 1e9:.2f} GFLOP")

    def bound(out_bytes):
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")

    def strips(col, block):
        rows = (ct[:, col, None].long() * block
                + torch.arange(block, device=fa.device))
        return fa[rows.clamp(max=n - 1)]

    sa = strips(0, bm)
    sb = strips(1, bn).transpose(1, 2).contiguous()

    def library():
        with ref.full_precision():
            return torch.bmm(sa, sb)

    rows = {}
    for name, out_bytes, kern, plain in (
            ("pair_scores_catalog_compact", 1024 * (cap + 1) * 4,
             lambda: ops.pair_scores_catalog_compact(
                 fa, fa, ct, capacity=cap, impl="cuda", **kw),
             lambda: ops.pair_scores_catalog_compact(
                 fa, fa, ct, capacity=cap, impl="torch", **kw)),
            ("pair_scores_catalog", 1024 * bm * bn * 4,
             lambda: ops.pair_scores_catalog(fa, fa, ct, impl="cuda", **kw),
             lambda: ops.pair_scores_catalog(fa, fa, ct, impl="torch",
                                             **kw))):
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1 = _time_ms(torch, plain, 5)
        k1 = _time_ms(torch, kern, 20)
        k2 = _time_ms(torch, kern, 20)
        p2 = _time_ms(torch, plain, 5)
        lib_ms = _time_ms(torch, library, 20)
        b_ms, b_by = bound(out_bytes)
        rows[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        log(f"{name}: kernel {k1:.3f} / {k2:.3f} ms  plain {p1:.3f} / "
            f"{p2:.3f} ms  library_ms {lib_ms:.3f} (torch.bmm on "
            f"pre-gathered strips, TF32 off — dot only: no gather, "
            f"predicate or compaction)  bound {b_ms:.3f} ms ({b_by}: "
            f"{flops / 1e9:.2f} GFLOP at 67 TFLOP/s f32 vs "
            f"{(in_bytes + out_bytes) / 1e6:.1f} MB at 3.35 TB/s)  "
            f"-> {flops / (rows[name]['ms'] * 1e-3) / 1e12:.2f} TFLOP/s")
    return rows


# ---------------------------------------------------------------------------

def main() -> int:
    if not (SRC / "repro_torch" / "csrc" / "pair_sim.cu").is_file():
        print("chip_smoke.py: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    name, count, smi = device_phase(torch)
    build_phase()
    kstats = new_stats()
    kernel_phase(torch, np, kstats)
    ds, _, main_launches = ds1_phase(torch)
    overflow_launches = overflow_phase(ds)
    times = timing_phase(torch, np, ds, kstats)

    phase("7 summary")
    summary = []
    for kname, line, launches, path in (
            ("pair_scores_catalog_compact", 409,
             main_launches["pair_scores_catalog_compact"],
             "DS1 pair_range run_er, default capacity"),
            ("pair_scores_catalog", 301,
             overflow_launches["pair_scores_catalog"],
             "DS1 pair_range run_er, compact_capacity=16 (overflow path)")):
        summary.append(dict(
            name=kname, route="cuda",
            source="src/repro_torch/csrc/pair_sim.cu",
            replaces=f"src/repro/kernels/pair_sim.py:{line}",
            launches=launches, path=path,
            max_abs_err=kstats[kname]["max_abs_err"],
            near_threshold_flips=kstats[kname]["near_flips"],
            compared_cases=kstats[kname]["cases"],
            tolerance=f"exact except cells whose f64 score is within "
                      f"{NEAR} of the threshold",
            **times[kname]))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

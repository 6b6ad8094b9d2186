#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device  — the card's name, the device count, its power limit;
  2. build   — the CUDA kernels from ``src/repro_torch/csrc`` and the
               grouped kernel's earlier design from ``yardsticks/`` (nvcc,
               one process per source, all at once), with the build seconds and
               what ``-Xptxas -v`` reports per kernel (registers and spills
               of the redesigned ones again on a line of their own), and
               the shared-memory models held against the kernels' own;
  3. kernels — each CUDA kernel against its plain PyTorch version on
               catalogs from real plans (all four strategies, the match_⊥
               cross job, zero pad rows) over several geometries, widths,
               dtypes and capacities;
  4. DS1     — ``run_er`` at the paper's DS1 size for every strategy on
               the catalog executor, against the reference executor for
               PairRange and SN (Basic and BlockSplit against PairRange's
               reference match set);
  5. overflow — DS1 PairRange with a 16-slot capacity, so chunks overflow
               and re-score through the dense-mask kernel;
  6. timing  — on the first 1024-tile chunk of the DS1 PairRange catalog
               (the main path's shapes): both kernels against their plain
               versions, then CUDA-event times of both, of the plain
               versions and of a library yardstick, beside the card's
               bound for the same work, each kernel's share of the bound
               and its ratio to the yardstick.

The third slice (the dense kernel, tuning, the supervisor, the service):

  D    dense — ``ops.pair_scores`` (the dense kernel) on the sweep of
               tests/test_kernels.py, kernel_bench's shapes and the first
               16,384 featurized DS1 titles (triangular, 128x128), f32 and
               bf16, each against its plain version; launches counted on
               those calls; CUDA-event times of the DS1 case beside the
               plain version, a ``matmul`` yardstick and the bound;
  ER-t tuned   — ``run_er(tune_tiles=True)`` at DS1 for every strategy:
               the picked geometry, tiles, matches (equal to phase 4's) and
               stage-1 kernel seconds beside 128x128's;
  ER-f faults  — supervised ``run_er`` at DS1 PairRange on 4 logical
               devices under a seeded fault script, without and with work
               stealing: 7,788 matches, rounds, retries, lost tiles;
  ER-s service — ``ERService`` over DS1 with the default
               ``ServiceConfig``, 64 micro-batches (a null-key query, a
               never-seen block, one batch of 512): streaming == batch
               against ``run_er`` over corpus ++ queries, no build or load
               in steady state, queries/s, p50/p99 ms per batch, launches
               per batch, the device's idle share (``torch.profiler``); the
               plain route on the card (equal but for near-threshold
               pairs); ``ERBatcher`` with 4 submitting threads; the
               supervised service under a fault script; the autotuned
               service's pinned geometry.

LM serving, granite-moe-1b-a400m (``repro_torch.serve.generate``):

  LM-a kernels — the flash-attention and grouped-matmul kernels against
               their plain versions at the main path's shapes (granite
               prefill and decode, phi-3-vision's prefill, a ragged S, head
               dims 16/32/64/80/96/128, G = 4, non-causal, scales -0.125 and
               0; grouped at block_t 128 and 8 with real routing), bf16 and
               f32, within the JAX package's own tolerances and per row band
               to each band's own scale;
  LM-b wiring — granite at full width, 2 layers, f32: prefill + 4 greedy
               decode steps on the kernel route against the plain versions
               (logits atol 2e-3 / rtol 1e-2, equal tokens), and
               prefill/decode consistency against ``forward``;
  LM-c slice — granite at full width and depth, bf16, random weights from
               seed 0: ``generate`` on 8 prompts of 2,048 tokens (32 new)
               and 2 of 1,000 (8 new), with the launches of both kernels,
               prefill seconds, decode ms per step, tokens/s and peak
               memory, and the kernel-vs-plain prefill logits at full depth;
  LM-e vlm    — phi-3-vision-4.2b (head dim 96) on the flash kernel route:
               full width, 2 layers, f32, against the plain versions; then
               full width and depth, bf16, random weights from seed 0,
               ``generate`` on 2 prompts of 576 patch embeddings + 1,024
               tokens (8 new), with launches, prefill seconds, decode ms,
               tokens/s, peak memory, the prefill's device breakdown and the
               kernel-vs-plain prefill logits; two greedy runs must agree;
  LM-d timing — CUDA-event times of the flash call of one prefill layer
               (granite's and phi-3-vision's shapes) and of the grouped call
               at block_t 128 (prefill) and 8 (decode), beside the plain
               versions, a library yardstick (SDPA; ``torch._grouped_mm``,
               and the per-expert ``matmul`` calls as a second one) and the
               card's bound, with each kernel's share of the bound and its
               ratio to the yardstick; the grouped calls also in turns with
               the kernel's earlier design (``yardsticks/``, built in phase
               2): back-to-back and device times (``torch.profiler``) and
               the host microseconds of one call.

Phases run in the order 1-6, D, ER-t, ER-f, ER-s, LM-a, LM-b, LM-c, LM-e,
LM-d, then 7, the
summary. The last two lines of standard output are the kernel
summary and ``{"ok": true, "device": {...}}``. Without a card, or without the repo
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import ctypes
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
PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16 tensor cores


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


def _kernel_label(fn):
    """A readable name for a mangled kernel instance and the dynamic shared
    memory its launch asks for."""
    from repro_torch.kernels import flash_attention, grouped_mm, pair_sim

    m = re.search(r"catalog_kernelI(\w+?)Li(\d+)ELi(\d+)ELb(\d)", fn)
    if m:
        bm, bn = int(m.group(2)), int(m.group(3))
        return (f"{'compact' if m.group(4) == '1' else 'mask'} "
                f"{'bf16' if 'bfloat16' in m.group(1) else 'f32'} "
                f"{bm}x{bn}", pair_sim.catalog_smem_bytes(bm, bn))
    m = re.search(r"flash_(bf16|f32)ILi(\d+)E", fn)
    if m:
        bf16 = m.group(1) == "bf16"
        return (f"flash {m.group(1)} D={m.group(2)}",
                flash_attention.smem_bytes(int(m.group(2)), bf16))
    m = re.search(r"dense_kernelI(\w+?)Li(\d+)ELi(\d+)E", fn)
    if m:
        bm, bn = int(m.group(2)), int(m.group(3))
        return (f"dense {'bf16' if 'bfloat16' in m.group(1) else 'f32'} "
                f"{bm}x{bn}", pair_sim.dense_smem_bytes(bm, bn))
    if "grouped_mm_tma" in fn:
        return "grouped tma bf16 block_t=128", grouped_mm.smem_bytes("tma")
    m = re.search(r"grouped_mm_decodeILi8EN\w*?DecodeCfgILi2ELi(\d)E", fn)
    if m:
        kernel = "decode" if m.group(1) == "2" else "decode_wide"
        return (f"grouped {kernel} bf16 block_t=8",
                grouped_mm.smem_bytes(kernel))
    m = re.search(r"grouped_mm_unalignedILi(\d+)E", fn)
    if m:
        return f"grouped unaligned bf16 block_t={m.group(1)}", 0
    m = re.search(r"grouped_mm_f32ILi(\d+)E", fn)
    if m:
        return f"grouped f32 block_t={m.group(1)}", 0
    return fn, 0


YARDSTICK_GROUPED = ROOT / "yardsticks" / "grouped_mm_mma_sync.cu"


def build_phase():
    """Builds every kernel of the port, and beside them the grouped
    kernel's earlier design (``yardsticks/``, LM-d's host and device
    yardstick) into ``build/yardstick``; returns (seconds, that library's
    path)."""
    from repro_torch.kernels import build, flash_attention, grouped_mm, pair_sim
    phase("2 build")
    t0 = time.perf_counter()
    ydir = build.BUILD_DIR / "yardstick"
    ydir.mkdir(parents=True, exist_ok=True)
    ylib = ydir / "libgrouped_mm_mma_sync.so"
    yproc = subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(ylib),
         str(YARDSTICK_GROUPED)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    build.build_all()
    ylog, _ = yproc.communicate()
    if yproc.returncode != 0:
        raise AssertionError(f"nvcc failed on {YARDSTICK_GROUPED}:\n{ylog}")
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
            r"ptxas info\s+: Used (\d+) registers(?:.*?(\d+) bytes smem)?",
            entry["log"])
        redesigned = []
        for fn, stack, st, ld, regs, smem in blocks:
            label, dyn = _kernel_label(fn)
            log(f"  {name}: {label:<22} regs {regs:>3}  spill st/ld "
                f"{st}/{ld} B  stack {stack} B  static smem {smem or 0} B  "
                f"dynamic smem {dyn} B")
            if label.startswith(("flash bf16", "grouped tma",
                                 "grouped decode")) or "128x128" in label:
                redesigned.append(f"{label}: {regs} regs, spill {st}/{ld} B")
        if redesigned:
            log(f"  {name}, the kernels this slice redesigned: "
                + "; ".join(redesigned))
    lib = pair_sim._lib()
    for bm, bn in pair_sim.GEOMETRY_LATTICE:
        got = lib.pair_sim_smem_bytes(bm, bn)
        if got != pair_sim.catalog_smem_bytes(bm, bn):
            raise AssertionError(f"shared-memory model disagrees with the "
                                 f"kernel at ({bm}, {bn}): {got}")
    flib = flash_attention._lib()
    for d in flash_attention.HEAD_DIMS:
        for bf16 in (True, False):
            got = flib.flash_attention_smem_bytes(d, int(bf16))
            if got != flash_attention.smem_bytes(d, bf16):
                raise AssertionError(f"flash shared-memory model disagrees "
                                     f"with the kernel at D={d}, bf16="
                                     f"{bf16}: {got}")
    glib = grouped_mm._lib()
    for i, kernel in enumerate(grouped_mm.KERNELS):
        got = glib.grouped_mm_smem_bytes(i)
        if got != grouped_mm.smem_bytes(kernel):
            raise AssertionError(f"grouped shared-memory model disagrees "
                                 f"with the {kernel} kernel: {got}")
    log("shared-memory models agree with the kernels (the catalog lattice, "
        "flash at every head dim, every TMA-fed grouped kernel)")
    log(f"yardstick: the grouped kernel's earlier design built from "
        f"{YARDSTICK_GROUPED.relative_to(ROOT)} into {ylib}")
    return seconds, ylib


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
    refs = {}
    # The reference executor runs for pair_range and SN only (the script's
    # time limit); basic and block_split plan the same pairs as pair_range
    # and are held to its reference match set.
    for strategy in ("pair_range", "sorted_neighborhood", "basic",
                     "block_split"):
        before = dict(stage1_stats)
        ops.reset_launch_counts()
        res = run_er(ds.titles, ERConfig(strategy=strategy), device="cuda")
        counts = ops.launch_counts()
        s1 = {k: stage1_stats[k] - before[k] for k in stage1_stats}
        if strategy in ("pair_range", "sorted_neighborhood"):
            refs[strategy] = run_er(
                ds.titles, ERConfig(strategy=strategy, executor="reference"),
                device="cuda")
        ref_res = refs.get(strategy, refs["pair_range"])
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
            + (f"(reference executor total "
               f"{ref_res.extra['timings']['total_s']:.3f})"
               if strategy in refs else
               "(held to pair_range's reference match set)"))
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
        ms = rows[name]["ms"]
        log(f"{name}: kernel {k1:.3f} / {k2:.3f} ms  plain {p1:.3f} / "
            f"{p2:.3f} ms  library_ms {lib_ms:.3f} (torch.bmm on "
            f"pre-gathered strips, TF32 off — dot only: no gather, "
            f"predicate or compaction)  bound {b_ms:.3f} ms ({b_by}: "
            f"{flops / 1e9:.2f} GFLOP at 67 TFLOP/s f32 vs "
            f"{(in_bytes + out_bytes) / 1e6:.1f} MB at 3.35 TB/s)  "
            f"-> {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
            f"{b_ms / ms:.1%} of the bound, {ms / lib_ms:.2f}x the library "
            f"time")
    return rows


# ---------------------------------------------------------------------------
# D: the dense pair_scores kernel
# ---------------------------------------------------------------------------

DENSE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_kernels.py
DENSE_LARGE_N = 16_384


def _dense_cases(torch, np, ds):
    """(label, a, b, threshold, triangular, (bm, bn)) in the order phase D
    drives them: the sweep of tests/test_kernels.py (threshold 0.3, blocks
    64 and 128), kernel_bench's shapes (n 1,024 and 4,096, d 256,
    triangular, threshold 0.8, tiles 128 and 256; unit rows, the kernel's
    contract) and the first 16,384 featurized DS1 titles (triangular,
    threshold 0.8, 128x128), each in f32 and bf16."""
    from repro_torch.er.encode import ngram_features

    rng = np.random.default_rng(0)

    def unit(n, d):
        x = rng.standard_normal((n, d)).astype(np.float32)
        return torch.from_numpy(
            x / np.linalg.norm(x, axis=1, keepdims=True)).cuda()

    cases = []
    for m, n, d in ((64, 64, 32), (200, 130, 64), (128, 128, 256),
                    (257, 31, 128)):
        for tri in (False, True):
            a = unit(m, d)
            b = a if tri else unit(n, d)
            for block in (64, 128):
                cases.append((f"sweep ({m},{m if tri else n},{d}) "
                              f"tri={tri} {block}x{block}", a, b, 0.3, tri,
                              (block, block)))
    for n in (1024, 4096):
        a = unit(n, 256)
        for block in (128, 256):
            cases.append((f"kernel_bench n={n} d=256 {block}x{block}", a, a,
                          0.8, True, (block, block)))
    feats = torch.from_numpy(ngram_features(
        ds.titles[:DENSE_LARGE_N], dim=256)).cuda()
    cases.append((f"DS1 first {DENSE_LARGE_N} titles 128x128", feats, feats,
                  0.8, True, (128, 128)))
    out = []
    for label, a, b, thr, tri, geo in cases:
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[-1]
            out.append((f"{label} {name}", a.to(dt).contiguous(),
                        b.to(dt).contiguous(), thr, tri, geo, name))
    return out


def _dense_check(torch, a, b, got, want, thr, name, label):
    """Kernel vs plain version: a cell kept by one side only must have an
    f64 score within NEAR of the threshold; cells both keep (or both drop)
    agree within DENSE_TOL. Returns (max |diff| over those cells, flips,
    kept cells)."""
    flip = (got == 0) != (want == 0)
    flips = int(flip.sum())
    if flips:
        i, j = flip.nonzero(as_tuple=True)
        s = (a[i].double() * b[j].double()).sum(dim=1)
        if not bool(((s - float(thr)).abs() <= NEAR).all()):
            raise AssertionError(f"dense kernel disagrees off the "
                                 f"threshold: {label}")
    err = (got - want).abs().masked_fill_(flip, 0).max().item()
    if not err <= DENSE_TOL[name]:
        raise AssertionError(f"dense kernel: {label} max |diff| {err}")
    return err, flips, int((got != 0).sum())


def dense_phase(torch, np, ds):
    """D: the dense kernel through ``ops.pair_scores`` on every case (the
    main path: launches counted here), each held against the plain
    version; then CUDA-event times of the large DS1 case."""
    from repro_torch.kernels import ops, ref

    phase("D dense pair_scores kernel vs plain version "
          "(ops.pair_scores, src/repro/kernels/pair_sim.py:164)")
    cases = _dense_cases(torch, np, ds)
    stats = {"cases": 0, "near_flips": 0, "max_abs_err": 0.0}
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    outs = [ops.pair_scores(a, b, threshold=thr, triangular=tri,
                            block_m=geo[0], block_n=geo[1], impl="auto")
            for _, a, b, thr, tri, geo, _ in cases]
    torch.cuda.synchronize()
    launches = ops.launch_counts()["pair_scores"]
    if launches != len(cases):
        raise AssertionError(f"pair_scores launched {launches} times for "
                             f"{len(cases)} calls")
    for (label, a, b, thr, tri, geo, name), got in zip(cases, outs):
        want = ops.pair_scores(a, b, threshold=thr, triangular=tri,
                               impl="torch")
        err, flips, kept = _dense_check(torch, a, b, got, want, thr, name,
                                        label)
        if tri and bool(got.tril().any()):
            raise AssertionError(f"dense kernel kept a cell on or below "
                                 f"the diagonal: {label}")
        stats["cases"] += 1
        stats["near_flips"] += flips
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        if "DS1" in label or "kernel_bench" in label:
            log(f"{label}: kept {kept} cells, max |kernel - plain| {err:.3e}"
                f" (tolerance {DENSE_TOL[name]}), {flips} near-threshold "
                f"flips")
        del want
    del outs
    log(f"{stats['cases']} cases equal to the plain version within "
        f"{DENSE_TOL['float32']} f32 / {DENSE_TOL['bfloat16']} bf16 "
        f"(cells kept by one side only: {stats['near_flips']}, each within "
        f"{NEAR} of the threshold); main-path launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")

    rows = {}
    for label, a, b, thr, tri, geo, name in cases:
        if "DS1" not in label:
            continue
        n, d = a.shape
        flops = 2.0 * d * n * (n - 1) / 2
        nbytes = a.numel() * a.element_size() + n * n * 4  # a is b
        peak = PEAK_F32_FLOPS if name == "float32" else PEAK_BF16_FLOPS
        t_ops = flops / peak * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        kw = dict(threshold=thr, triangular=tri)

        def kern(a=a, b=b, kw=kw, geo=geo):
            return ops.pair_scores(a, b, block_m=geo[0], block_n=geo[1],
                                   impl="cuda", **kw)

        def plain(a=a, b=b, kw=kw):
            return ops.pair_scores(a, b, impl="torch", **kw)

        def library(a=a, b=b, thr=thr):
            with ref.full_precision():
                s = torch.matmul(a.float(), b.float().T)
            return torch.where(s >= thr, s, 0.0).triu(1)

        p1 = _time_ms(torch, plain, 3)
        k1 = _time_ms(torch, kern, 5)
        k2 = _time_ms(torch, kern, 5)
        p2 = _time_ms(torch, plain, 3)
        lib_ms = _time_ms(torch, library, 3)
        ms = (k1 + k2) / 2
        rows[name] = dict(ms=ms, plain_ms=(p1 + p2) / 2, bound_ms=bound,
                          bound_by=by, library_ms=lib_ms)
        log(f"{label}: kernel {k1:.3f} / {k2:.3f} ms  plain {p1:.3f} / "
            f"{p2:.3f} ms  library_ms {lib_ms:.3f} (torch.matmul in f32, "
            f"TF32 off, then where and triu(1))  bound {bound:.3f} ms ({by}:"
            f" {flops / 1e9:.2f} GFLOP at {peak / 1e12:.0f} TFLOP/s = "
            f"{t_ops:.3f} ms vs {nbytes / 1e9:.3f} GB at 3.35 TB/s = "
            f"{t_bytes:.3f} ms) -> {flops / (ms * 1e-3) / 1e12:.2f} "
            f"TFLOP/s, {bound / ms:.1%} of the bound, "
            f"{ms / lib_ms:.2f}x the library time")
    del cases
    torch.cuda.empty_cache()
    return stats, launches, rows


# ---------------------------------------------------------------------------
# ER-t / ER-f: tuned and supervised run_er at DS1
# ---------------------------------------------------------------------------

DS1_SN_MATCHES = 7_715


def er_tuned_phase(ds, ds1_rows):
    """ER-t: ``run_er(tune_tiles=True)`` at DS1 for every strategy, beside
    phase 4's 128x128 runs."""
    from repro_torch.er import ERConfig, run_er
    from repro_torch.kernels import ops

    phase("ER-t tuned run_er at DS1 (ERConfig(tune_tiles=True))")
    want = {"pair_range": DS1_PAIR_RANGE["matches"],
            "sorted_neighborhood": DS1_SN_MATCHES}
    for strategy in STRATEGIES:
        base, _ = ds1_rows[strategy]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_er(ds.titles, ERConfig(strategy=strategy, tune_tiles=True),
                     device="cuda")
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        if res.matches != base.matches:
            raise AssertionError(f"{strategy}: tuned matches differ from "
                                 f"128x128's")
        if len(res.matches) != want.get(strategy, len(base.matches)):
            raise AssertionError(f"{strategy}: {len(res.matches)} matches")
        if counts["pair_scores_catalog_compact"] == 0:
            raise AssertionError(f"{strategy}: compact kernel not launched")
        tm, tb = res.extra["timings"], base.extra["timings"]
        log(f"[{strategy}] tuned geometry {res.extra['tuned_geometry']}: "
            f"tiles {res.extra['catalog_tiles']} (128x128: "
            f"{base.extra['catalog_tiles']}), matches {len(res.matches)} "
            f"(equal), stage-1 kernel {tm['stage1_s']:.4f} s (128x128: "
            f"{tb['stage1_s']:.4f} s), decode {tm['decode_s']:.4f} s, "
            f"plan/lower/schedule incl. autotune {tm['plan_s']:.3f} s "
            f"(128x128: {tb['plan_s']:.3f} s), total {wall:.3f} s "
            f"(128x128: {tb['total_s']:.3f} s); launches {counts}")


def er_faults_phase(ds):
    """ER-f: supervised ``run_er`` at DS1 PairRange on 4 logical devices
    under a seeded fault script, without and with work stealing."""
    from repro_torch.er import ERConfig, FaultInjector, FaultScript, run_er
    from repro_torch.kernels import ops

    phase("ER-f supervised run_er at DS1 pair_range, supervised_devices=4, "
          "FaultScript.random(seed=0, n_dev=4, n_events=8, max_step=8)")
    for steal in (None, 1.5):
        script = FaultScript.random(0, 4, 8, max_step=8,
                                    straggle_delay=1e6)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_er(ds.titles, ERConfig(
            supervised_devices=4, shard_deadline_s=60.0, max_retries=10,
            steal_factor=steal), fault_injector=FaultInjector(script),
            device="cuda")
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        if len(res.matches) != DS1_PAIR_RANGE["matches"] \
                or res.coverage != 1.0:
            raise AssertionError(f"supervised run: {len(res.matches)} "
                                 f"matches, coverage {res.coverage}")
        kinds = {}
        for e in script.events:
            kinds[e.kind] = kinds.get(e.kind, 0) + 1
        log(f"steal_factor={steal}: script {kinds}; matches "
            f"{len(res.matches)} (quiet run {DS1_PAIR_RANGE['matches']}), "
            f"rounds {res.attempts}, retries {res.attempts - 1}, recovered "
            f"tiles {res.recovered_tiles}, lost tiles 0 (coverage "
            f"{res.coverage}), steals {res.steals}, measured makespan "
            f"{res.measured_makespan_s:.3f} s, wall {wall:.3f} s; launches "
            f"{counts}")


# ---------------------------------------------------------------------------
# ER-s: the resident service at DS1
# ---------------------------------------------------------------------------

ER_S_BATCHES = 64


def er_s_traffic(np, titles):
    """64 micro-batches of 1-128 perturbed corpus titles (seed 1, as
    examples/match_service.py makes them); batch 3 leads with a null-key
    query, batch 5 with a never-seen block, batch 10 holds 512 queries."""
    rng = np.random.default_rng(1)
    batches = []
    for i in range(ER_S_BATCHES):
        size = 512 if i == 10 else int(rng.integers(1, 129))
        batch = []
        for _ in range(size):
            s = list(titles[int(rng.integers(0, len(titles)))])
            s[int(rng.integers(3, len(s)))] = "x"
            batch.append("".join(s))
        if i == 3:
            batch[0] = ""
        if i == 5:
            batch[0] = "@@@ brand new block"
        batches.append(batch)
    return batches


def _serve(svc, batches):
    """Serve ``batches`` in order: (per-batch responses, per-batch ms)."""
    out, ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        out.append(svc.match(batch))
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def _union(responses, batches):
    got, off = set(), 0
    for resp, batch in zip(responses, batches):
        got.update((a, b + off) for a, b in resp)
        off += len(batch)
    return got


def er_service_phase(torch, np, ds):
    """ER-s: ERService at DS1 on the card — streaming ≡ batch, the plain
    route, the build/load counter, timings and the device's idle share,
    then ERBatcher, the supervised service under faults and the autotuned
    service."""
    import threading

    from repro_torch.er import (ERBatcher, ERConfig, ERService,
                                FaultInjector, FaultScript, ServiceConfig,
                                compile_counter, cross_restrict, featurize,
                                run_er)
    from repro_torch.kernels import ops

    phase(f"ER-s the resident service: ERService(make_products({DS1_N}, "
          f"seed=0), ServiceConfig()), {ER_S_BATCHES} micro-batches")
    corpus = list(ds.titles)
    batches = er_s_traffic(np, corpus)
    queries = [q for b in batches for q in b]
    t0 = time.perf_counter()
    svc = ERService(corpus, ServiceConfig(), device="cuda")
    ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    with compile_counter() as warm:
        svc.warmup()
    warm_s = time.perf_counter() - t0
    log(f"ingest {ingest:.3f} s ({svc.n_corpus} titles, {svc.bdm.shape[0]} "
        f"blocks; service-reported {svc.ingest_seconds:.3f} s); warmup "
        f"{warm_s:.3f} s ({warm.count} builds/loads in warmup); "
        f"{len(queries)} queries in {len(batches)} batches")

    ops.reset_launch_counts()
    with compile_counter() as steady:
        responses, ms = _serve(svc, batches)
    launches = ops.launch_counts()
    if steady.count != 0:
        raise AssertionError(f"{steady.count} builds/loads in steady state")
    if launches["pair_scores_catalog_compact"] == 0:
        raise AssertionError("the service launched no compact kernel")
    served = _union(responses, batches)
    t0 = time.perf_counter()
    oneshot = run_er(corpus + queries, ERConfig(strategy="pair_range"),
                     device="cuda")
    want = cross_restrict(oneshot.matches, len(corpus))
    if served != want:
        raise AssertionError(f"streaming != batch: {len(served)} served vs "
                             f"{len(want)} from run_er over corpus ++ "
                             f"queries")
    ms_a = np.asarray(ms)
    total_s = ms_a.sum() / 1e3
    log(f"streaming == batch: {len(served)} cross matches, equal to "
        f"run_er over corpus ++ queries restricted to cross pairs "
        f"({time.perf_counter() - t0:.1f} s); steady-state builds/loads 0")
    log(f"served {len(queries)} queries in {total_s:.3f} s: "
        f"{len(queries) / total_s:.1f} queries/s; per batch p50 "
        f"{np.percentile(ms_a, 50):.2f} ms, p99 "
        f"{np.percentile(ms_a, 99):.2f} ms, max {ms_a.max():.2f} ms; "
        f"kernel launches {launches} = "
        f"{launches['pair_scores_catalog_compact'] / len(batches):.2f} "
        f"compact launches per batch; stats planned_pairs "
        f"{svc.stats['planned_pairs']} bucket_hits "
        f"{svc.stats['bucket_hits']}")

    holder = {}
    wall, cats = device_breakdown(
        torch, lambda: holder.update(r=_serve(svc, batches)[0]),
        kernels=ER_KERNELS)
    if [set(r) for r in holder["r"]] != [set(r) for r in responses]:
        raise AssertionError("a second pass served other matches")
    busy = cats["catalog_kernels"] + cats["other"]
    top = sorted(cats["other_by_name"].items(), key=lambda kv: -kv[1])[:5]
    idle = 1 - busy / wall if busy else float("nan")
    log(f"device over the stream (torch.profiler, second pass): wall "
        f"{wall:.3f} s, device busy {busy * 1e3:.2f} ms = catalog kernels "
        f"{cats['catalog_kernels'] * 1e3:.2f} + other kernels and copies "
        f"{cats['other'] * 1e3:.2f} ms ({cats['device_events']} events); "
        f"device idle {idle:.2%} of the wall time; largest others: "
        + "; ".join(f"{n} {sec * 1e3:.2f} ms" for n, sec in top))

    # the plain versions on the card: equal except near-threshold pairs
    plain = ERService(corpus, ServiceConfig(kernel_impl="torch"),
                      device="cuda")
    plain_resp, plain_ms = _serve(plain, batches)
    diff = _union(plain_resp, batches) ^ served
    if diff:
        cfg = ServiceConfig()
        _, _, fc = featurize(corpus, cfg)
        _, _, fq = featurize(queries, cfg)
        thr = float(np.float32(cfg.threshold - cfg.filter_margin))
        for c, q in sorted(diff):
            s = float(np.dot(fc[c].astype(np.float64),
                             fq[q].astype(np.float64)))
            log(f"  kernel/plain differ on (corpus {c}, query {q}): f64 "
                f"stage-1 score {s!r}")
            if abs(s - thr) > NEAR:
                raise AssertionError("kernel and plain routes differ off "
                                     "the threshold")
    log(f"kernel_impl='torch' on the card: {len(diff)} pairs differ from "
        f"the kernel route (each within {NEAR} of the stage-1 threshold); "
        f"{len(queries) / (sum(plain_ms) / 1e3):.1f} queries/s")
    del plain

    # ERBatcher: 4 submitting threads, per-request answers
    got = [None] * len(batches)
    errors = []
    t0 = time.perf_counter()
    with ERBatcher(svc, max_delay_s=0.005) as bat:
        def submit(k):
            try:
                for i in range(k, len(batches), 4):
                    got[i] = bat.submit(batches[i]).result(timeout=600)
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=submit, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
    bat_s = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"ERBatcher failed: {errors}")
    if [set(r) for r in got] != [set(r) for r in responses]:
        raise AssertionError("ERBatcher answers differ from the service's")
    log(f"ERBatcher, 4 submitting threads: every per-request answer equals "
        f"the service's; {len(queries) / bat_s:.1f} queries/s; stats "
        f"{bat.stats}")

    # the supervised service under a fault script
    sup = ERService(corpus, ServiceConfig(exec_devices=4, max_retries=8,
                                          backoff_s=0.0,
                                          shard_deadline_s=60.0),
                    device="cuda")
    sup.warmup()
    script = FaultScript.random(0, 4, 8, straggle_delay=1e6)
    sup.set_fault_injector(FaultInjector(script))
    sup_resp, sup_ms = _serve(sup, batches)
    coverage = min(r.coverage for r in sup_resp)
    if coverage != 1.0 or [set(r) for r in sup_resp] != \
            [set(r) for r in responses]:
        raise AssertionError(f"supervised service: coverage {coverage} or "
                             f"other matches")
    log(f"exec_devices=4 under FaultScript.random(0, 4, 8): coverage 1.0 on "
        f"every batch, matches equal; retries {sup.stats['retries']}, "
        f"recovered tiles {sup.stats['recovered_tiles']}, breaker "
        f"evictions {sup.stats['breaker_evictions']}; "
        f"{len(queries) / (sum(sup_ms) / 1e3):.1f} queries/s")
    del sup

    # the autotuned service
    tuned = ERService(corpus, ServiceConfig(autotune_tiles=True),
                      device="cuda")
    t0 = time.perf_counter()
    tuned.warmup()
    tune_s = time.perf_counter() - t0
    tuned_resp, tuned_ms = _serve(tuned, batches)
    if [set(r) for r in tuned_resp] != [set(r) for r in responses]:
        raise AssertionError("the autotuned service serves other matches")
    best = ", ".join(f"{s.geometry} {s.predicted_seconds * 1e3:.1f} ms"
                     for s in tuned.tune_report.scores[:4])
    log(f"autotune_tiles=True: pinned {tuned.tile_geometry} after a "
        f"{tune_s:.2f} s warmup sweep (best measured: {best}); matches "
        f"equal; {len(queries) / (sum(tuned_ms) / 1e3):.1f} queries/s "
        f"(128x128: {len(queries) / total_s:.1f})")
    return launches


# ---------------------------------------------------------------------------
# LM serving: granite-moe-1b-a400m through repro_torch.serve.generate
# ---------------------------------------------------------------------------

GRANITE = "granite-moe-1b-a400m"
FLASH_TOL = {"float32": 5e-4, "bfloat16": 3e-2}    # tests/test_kernels.py
GROUPED_TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # (the JAX package's own)
LM_B_TOL = dict(atol=2e-3, rtol=1e-2)              # tests/test_arch_smoke.py
LM_C_RUNS = ((8, 2048, 32), (2, 1000, 8))          # (prompts, length, new)
PHI3 = "phi-3-vision-4.2b"
LM_E_RUN = (2, 1024, 8)   # prompts, tokens after the 576 patches, new
LM_A_FLASH = (  # (B, H, KVH, S, D, causal, scale), each in bf16 and f32
    (8, 16, 8, 2048, 64, True, None),    # granite prefill (LM-c's first run)
    (2, 16, 8, 1000, 64, True, None),    # ragged S (LM-c's second run)
    (2, 16, 4, 512, 16, True, None), (2, 8, 8, 384, 32, True, None),
    (1, 16, 4, 1024, 128, True, None),   # G = 4
    (2, 16, 8, 1024, 64, False, None),
    (2, 32, 32, 1600, 96, True, None),   # phi-3-vision prefill (LM-e)
    (1, 8, 4, 333, 80, True, None),      # zamba2's head dim, ragged S
    (1, 8, 4, 1024, 96, False, None),
    (2, 16, 8, 1000, 64, True, -0.125),  # scale < 0 and scale 0
    (1, 8, 8, 512, 96, True, 0.0), (1, 8, 4, 1024, 80, False, -0.125))


def granite(torch, arch=GRANITE, **over):
    """``arch`` (granite-moe-1b-a400m by default) at full width, random
    weights from seed 0 on the card; ``over`` replaces config fields
    (depth, dtype, routes)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = get_config(arch).replace(**over)
    gen = torch.Generator("cuda").manual_seed(0)
    return cfg, get_model(cfg).init(cfg, gen, device="cuda")


def routed_layout(torch, model, cfg, tokens):
    """Real routing for the grouped kernel: layer 0's router on the normed
    embeddings of ``tokens`` (B, S) → (x (T, d), tile-aligned xg (tp, d),
    tile_expert, block_t, real rows T·k)."""
    from repro_torch.models import moe
    from repro_torch.models.layers import rms_norm

    p = model.layers[0]
    h = model.embed[tokens.reshape(-1)]
    x = rms_norm(h, p.ln_mlp, cfg.rms_eps)
    _, ids, _ = moe._route(p, x, cfg)
    order, dst, te, tp, bt = moe.grouped_layout(ids, cfg.num_experts)
    xg = torch.zeros((tp, x.shape[1]), dtype=x.dtype, device=x.device)
    xg[dst] = x[order // cfg.top_k]
    return xg, te, bt, ids.numel(), ids


def lm_kernels_phase(torch, np):
    """LM-a: both LM kernels against their plain versions on the card at
    the main path's shapes; returns per-kernel max |kernel - plain| (and
    flash's largest band error, ``ref.band_rel_err``)."""
    from repro_torch.kernels import ops, ref

    phase("LM-a LM kernels vs plain versions (granite and phi-3-vision "
          "shapes, head dims 16-128, scales <= 0)")
    rng = np.random.default_rng(0)
    errs = {"flash_attention": 0.0, "flash_band": 0.0, "grouped_matmul": 0.0,
            "grouped_band": 0.0}
    cases = {"flash_attention": 0, "grouped_matmul": 0}

    def normal(shape, dtype, scale=1.0):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).cuda().to(dtype)

    for b, h, kvh, s, d, causal, scale in LM_A_FLASH:
        for name in ("bfloat16", "float32"):
            dt = getattr(torch, name)
            q, k, v = (normal((b, n, s, d), dt) for n in (h, kvh, kvh))
            got = ops.attention(q, k, v, causal=causal, scale=scale,
                                impl="cuda")
            want = ops.attention(q, k, v, causal=causal, scale=scale,
                                 impl="torch")
            err = (got.float() - want.float()).abs().max().item()
            band = ref.band_rel_err(got, want)
            log(f"flash {name:<8} B={b} H={h} KVH={kvh} S={s} D={d} "
                f"causal={causal} scale={scale}: max_abs_err {err:.3e} "
                f"(tolerance "
                f"{FLASH_TOL[name]}), max err / max |plain| over 64-row "
                f"bands {band:.3e} (tolerance "
                f"{ref.ATTENTION_BAND_TOL[name]:.3e})")
            if not (err <= FLASH_TOL[name]
                    and band <= ref.ATTENTION_BAND_TOL[name]):
                raise AssertionError("flash kernel disagrees with its "
                                     "plain version")
            errs["flash_attention"] = max(errs["flash_attention"], err)
            errs["flash_band"] = max(errs["flash_band"], band)
            cases["flash_attention"] += 1

    cfg, model = granite(torch, n_layers=1)
    ex = model.layers[0].experts
    b0, s0 = LM_C_RUNS[0][:2]
    for b, s in ((b0, s0), (b0, 1)):      # prefill (block_t 128), decode (8)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).cuda()
        xg, te, bt, real, _ = routed_layout(torch, model, cfg, toks)
        for name in ("bfloat16", "float32"):
            dt = getattr(torch, name)
            for wname in ("w_gate", "w_down"):
                w = getattr(ex, wname).to(dt)
                x = xg.to(dt)
                if wname == "w_down":    # its input is the expert hidden
                    x = normal((xg.shape[0], w.shape[1]), dt)
                got = ops.grouped_matmul(x, te, w, block_t=bt, impl="cuda")
                want = ops.grouped_matmul(x, te, w, block_t=bt,
                                          impl="torch")
                err = (got.float() - want.float()).abs().max().item()
                band = ref.band_rel_err(got, want, band=bt)
                log(f"grouped {name:<8} block_t={bt} rows {x.shape[0]} "
                    f"(real {real}) d={x.shape[1]} {wname} F={w.shape[2]}: "
                    f"max_abs_err {err:.3e} (tolerance {GROUPED_TOL[name]})"
                    f", max err / max |plain| over {bt}-row bands "
                    f"{band:.3e} (tolerance "
                    f"{ref.GROUPED_BAND_TOL[name]:.3e})")
                if not (err <= GROUPED_TOL[name]
                        and band <= ref.GROUPED_BAND_TOL[name]):
                    raise AssertionError("grouped kernel disagrees with its "
                                         "plain version")
                errs["grouped_matmul"] = max(errs["grouped_matmul"], err)
                errs["grouped_band"] = max(errs["grouped_band"], band)
                cases["grouped_matmul"] += 1
    torch.cuda.synchronize()
    del model
    return errs, cases


def _prefill_and_decode(torch, model, cfg, tokens, steps):
    """prefill + ``steps`` greedy decode steps through the serving entry
    points; returns (logits per step (B, V) f32, tokens per step)."""
    from repro_torch.models import get_model
    from repro_torch.serve import make_decode_step, make_prefill

    b, s = tokens.shape
    cache = get_model(cfg).init_cache(cfg, b, s + steps + 1)
    logits, cache = make_prefill(cfg)(model, {"tokens": tokens}, cache)
    out, toks = [logits[:, -1].float()], []
    decode = make_decode_step(cfg)
    for _ in range(steps):
        toks.append(out[-1].argmax(-1))
        logits, cache = decode(model, toks[-1][:, None], cache)
        out.append(logits[:, -1].float())
    return out, toks


def lm_wiring_phase(torch, np):
    """LM-b: granite at full width, 2 layers, f32: the kernel route against
    the plain versions on the card, and prefill/decode consistency."""
    from repro_torch.kernels import ops
    from repro_torch.models import get_model

    phase("LM-b model wiring: granite full width, n_layers=2, float32")
    kern, model = granite(torch, n_layers=2, param_dtype="float32",
                          compute_dtype="float32", attn_impl="kernel",
                          moe_dispatch="grouped")
    plain = kern.replace(attn_impl="plain", kernel_impl="torch")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, kern.vocab, (4, 256))).cuda()
    ops.reset_launch_counts()
    lk, tk = _prefill_and_decode(torch, model, kern, tokens, 4)
    counts = ops.launch_counts()
    lp, tpl = _prefill_and_decode(torch, model, plain, tokens, 4)
    if ops.launch_counts() != counts:
        raise AssertionError("the plain route launched a kernel")
    worst = 0.0
    for i, (a, b) in enumerate(zip(lk, lp)):
        worst = max(worst, (a - b).abs().max().item())
        if not torch.allclose(a, b, **LM_B_TOL):
            raise AssertionError(f"LM-b step {i}: kernel and plain logits "
                                 f"differ by {(a - b).abs().max().item()}")
    if not all(torch.equal(a, b) for a, b in zip(tk, tpl)):
        raise AssertionError("LM-b: greedy tokens differ")
    log(f"kernel route (launches {counts}) vs plain versions: prefill + 4 "
        f"decode steps, B=4 S=256: max |logit diff| {worst:.3e} within atol "
        f"{LM_B_TOL['atol']} / rtol {LM_B_TOL['rtol']}; greedy tokens equal "
        f"{[t.tolist() for t in tk]}")
    # prefill/decode consistency (tests/test_arch_smoke.py) on the kernel
    # route: forward over the prompt and over prompt + next token
    mod = get_model(kern)
    full = mod.forward(model, {"tokens": tokens}, kern)[:, -1].float()
    nxt = torch.cat([tokens, tk[0][:, None]], dim=1)
    full2 = mod.forward(model, {"tokens": nxt}, kern)[:, -1].float()
    d1 = (lk[0] - full).abs().max().item()
    d2 = (lk[1] - full2).abs().max().item()
    if not (torch.allclose(lk[0], full, **LM_B_TOL)
            and torch.allclose(lk[1], full2, **LM_B_TOL)):
        raise AssertionError(f"prefill/decode inconsistent: {d1}, {d2}")
    log(f"prefill vs forward max diff {d1:.3e}; decode step vs forward "
        f"max diff {d2:.3e} (atol {LM_B_TOL['atol']} / rtol "
        f"{LM_B_TOL['rtol']})")
    del model
    return worst


LM_KERNELS = (("flash_attention", "flash_"), ("grouped_matmul", "grouped_mm"))
ER_KERNELS = (("catalog_kernels", "catalog_kernel"),)


def device_breakdown(torch, fn, kernels=LM_KERNELS):
    """Run ``fn`` under ``torch.profiler`` (CPU + CUDA activity) and split
    the device's kernel time into ``kernels`` ((category, substring of the
    kernel's name) pairs) and everything else (PyTorch's own kernels,
    copies): (wall s, {category: device s}). The profiler's own cost is in
    the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cats = {name: 0.0 for name, _ in kernels}
    cats.update({"other": 0.0, "device_events": 0, "other_by_name": {}})
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        key = next((name for name, sub in kernels if sub in e.name),
                   "other")
        sec = e.time_range.elapsed_us() * 1e-6
        cats[key] += sec
        cats["device_events"] += 1
        if key == "other":
            by = cats["other_by_name"]
            by[e.name[:70]] = by.get(e.name[:70], 0.0) + sec
    return wall, cats


def _log_breakdown(label, wall, cats, steps=1):
    busy = cats["flash_attention"] + cats["grouped_matmul"] + cats["other"]
    if busy == 0:
        log(f"{label}: the profiler saw no device time (not measured)")
        return
    log(f"{label} (torch.profiler, per step): wall {wall / steps * 1e3:.2f} "
        f"ms; device busy {busy / steps * 1e3:.2f} ms = flash "
        f"{cats['flash_attention'] / steps * 1e3:.2f} + grouped "
        f"{cats['grouped_matmul'] / steps * 1e3:.2f} + other kernels "
        f"{cats['other'] / steps * 1e3:.2f} ms; device idle "
        f"{1 - busy / wall:.1%} of the wall time; "
        f"{cats['device_events'] / steps:.0f} kernels and copies a step")
    top = sorted(cats["other_by_name"].items(), key=lambda kv: -kv[1])[:6]
    log("  largest other kernels (ms per step): " + "; ".join(
        f"{name} {sec / steps * 1e3:.2f}" for name, sec in top))


def lm_slice_phase(torch, np):
    """LM-c: granite at full width and depth, bf16, flash + grouped kernels,
    through ``generate``; returns the launches of the main path's runs."""
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.serve import generate, make_decode_step, make_prefill

    phase("LM-c the slice: generate, granite-moe-1b-a400m full width and "
          "depth, bf16, attn_impl=kernel, moe_dispatch=grouped, seed 0")
    cfg, model = granite(torch, attn_impl="kernel", moe_dispatch="grouped")
    n_params = sum(p.numel() for p in model.parameters())
    n_matrix = sum(p.numel() for p in model.parameters() if p.dim() > 1)
    log(f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"/ {cfg.n_kv_heads} KV, {cfg.num_experts} experts top-"
        f"{cfg.top_k}, vocab {cfg.vocab}: {n_params:,} parameters "
        f"({n_params * 2 / 1e9:.2f} GB bf16; {n_matrix:,} in matrices, "
        f"ModelConfig.param_count() {cfg.param_count():,})")
    if n_matrix != cfg.param_count():
        raise AssertionError("parameter count differs from the config's")
    rng = np.random.default_rng(0)
    launches = {"flash_attention": 0, "grouped_matmul": 0,
                "grouped_matmul[block_t=8]": 0,
                "grouped_matmul[block_t=128]": 0}
    rows = []
    for b, s, new in LM_C_RUNS:
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).cuda()
        batch = {"tokens": tokens}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = generate(model, cfg, batch, new)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for k in launches:
            launches[k] += counts[k]
        if out.shape != (b, new) or not bool(
                ((out >= 0) & (out < cfg.vocab)).all()):
            raise AssertionError(f"generate returned {tuple(out.shape)} or "
                                 "ids outside the vocabulary")
        # warm timings: prefill alone, then generate again (same tokens:
        # the grouped combine has no atomics)
        cache = get_model(cfg).init_cache(cfg, b, s + new)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = make_prefill(cfg)(model, batch, cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite prefill logits")
        t0 = time.perf_counter()
        again = generate(model, cfg, batch, new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        if not torch.equal(out, again):
            raise AssertionError("two greedy runs gave different tokens")
        decode_ms = (gen_s - prefill_s) / max(new - 1, 1) * 1e3
        log(f"B={b} prompts x {s} tokens, {new} new: launches {counts}; "
            f"first generate {first_s:.3f} s (cold); prefill {prefill_s:.3f} s;"
            f" generate {gen_s:.3f} s -> decode {decode_ms:.2f} ms/token-step"
            f" ({b * new / gen_s:.1f} tokens/s, {b * s / prefill_s:,.0f} "
            f"prompt tokens/s in prefill); peak memory {peak / 2**30:.2f} GiB;"
            f" tokens[0][:8] {out[0, :8].tolist()}; repeat run equal")
        rows.append(dict(b=b, s=s, new=new, prefill_s=prefill_s,
                         generate_s=gen_s, decode_ms=decode_ms,
                         tokens_per_s=b * new / gen_s, peak_bytes=peak,
                         launches=counts))
        if b == LM_C_RUNS[0][0]:
            cache = get_model(cfg).init_cache(cfg, b, s + 5)
            wall, cats = device_breakdown(
                torch, lambda: make_prefill(cfg)(model, batch, cache))
            _log_breakdown(f"prefill B={b} S={s}", wall, cats)
            step = make_decode_step(cfg)
            nxt = out[:, :1].long()

            def decode4():
                for _ in range(4):
                    step(model, nxt, cache)
            wall, cats = device_breakdown(torch, decode4)
            _log_breakdown(f"decode step B={b} at position {s}", wall, cats,
                           steps=4)
            plain = cfg.replace(attn_impl="plain", kernel_impl="torch")
            cache = get_model(plain).init_cache(plain, b, s + 1)
            ref_logits, _ = make_prefill(plain)(model, batch, cache)
            diff = (logits.float() - ref_logits.float()).abs().max().item()
            log(f"full depth, bf16: kernel vs plain-version prefill logits "
                f"max |diff| {diff:.3e} (informative; logit scale "
                f"{ref_logits.float().abs().max().item():.2f})")
            rows[-1]["plain_logit_diff"] = diff
    if not (launches["flash_attention"] > 0
            and launches["grouped_matmul[block_t=8]"] > 0
            and launches["grouped_matmul[block_t=128]"] > 0):
        raise AssertionError(f"the serving path missed a kernel: {launches}")
    log(f"launches over both runs: {launches}")
    return cfg, model, launches, rows


def _phi3_batch(torch, np, cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(
                rng.integers(0, cfg.vocab, (b, s))).cuda(),
            "patches": torch.from_numpy(rng.standard_normal(
                (b, cfg.n_patches, cfg.d_model)).astype(np.float32)).cuda()}


def lm_vlm_phase(torch, np):
    """LM-e: phi-3-vision-4.2b (head dim 96) on the flash kernel route.
    First at full width, 2 layers, f32: the kernel route against the plain
    versions (logits within LM-b's tolerance, equal tokens). Then at full
    width and depth, bf16, random weights from seed 0, through
    ``generate``: 2 prompts of 576 patch embeddings + 1,024 tokens (S =
    1,600, ragged against the 128-row tiles), 8 new tokens, with the
    launches, prefill s, decode ms, tokens/s, peak memory, the prefill's
    device breakdown, and the kernel-vs-plain prefill logits. Returns the
    launches of the full-depth run and its numbers."""
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.serve import generate, make_prefill

    phase("LM-e phi-3-vision-4.2b on the kernel route (head dim 96)")
    kern, model = granite(torch, PHI3, n_layers=2, param_dtype="float32",
                          compute_dtype="float32", attn_impl="kernel")
    plain = kern.replace(attn_impl="plain", kernel_impl="torch")
    batch = _phi3_batch(torch, np, kern, 2, 200, 3)
    cache = get_model(kern).init_cache(kern, 2, kern.n_patches + 201)
    ops.reset_launch_counts()
    lk, _ = make_prefill(kern)(model, batch, cache)
    counts = ops.launch_counts()
    cache = get_model(plain).init_cache(plain, 2, plain.n_patches + 201)
    lp, _ = make_prefill(plain)(model, batch, cache)
    diff = (lk.float() - lp.float()).abs().max().item()
    tk = generate(model, kern, batch, 4)
    tpl = generate(model, plain, batch, 4)
    if counts["flash_attention"] != kern.n_layers or not torch.allclose(
            lk.float(), lp.float(), **LM_B_TOL) or not torch.equal(tk, tpl):
        raise AssertionError(f"LM-e 2 layers f32: launches {counts}, logits "
                             f"differ by {diff}, tokens {tk.tolist()} vs "
                             f"{tpl.tolist()}")
    log(f"full width, 2 layers, f32, S = {kern.n_patches} + 200: kernel vs "
        f"plain prefill logits max |diff| {diff:.3e} within atol "
        f"{LM_B_TOL['atol']} / rtol {LM_B_TOL['rtol']}; 4 greedy tokens "
        f"equal {tk.tolist()}; flash launches {counts['flash_attention']}")
    del model

    cfg, model = granite(torch, PHI3, attn_impl="kernel")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"/ {cfg.n_kv_heads} KV, head dim {cfg.hd}, {cfg.n_patches} patches, "
        f"vocab {cfg.vocab}: {n_params:,} parameters "
        f"({n_params * 2 / 1e9:.2f} GB bf16)")
    b, s, new = LM_E_RUN
    batch = _phi3_batch(torch, np, cfg, b, s, 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = generate(model, cfg, batch, new)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if out.shape != (b, new) or not bool(
            ((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"generate returned {tuple(out.shape)} or ids "
                             "outside the vocabulary")
    if launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"the phi-3-vision prefill missed the flash "
                             f"kernel: {launches}")
    total = cfg.n_patches + s
    cache = get_model(cfg).init_cache(cfg, b, total + new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = make_prefill(cfg)(model, batch, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite prefill logits")
    t0 = time.perf_counter()
    again = generate(model, cfg, batch, new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if not torch.equal(out, again):
        raise AssertionError("two greedy runs gave different tokens")
    decode_ms = (gen_s - prefill_s) / max(new - 1, 1) * 1e3
    log(f"B={b} x ({cfg.n_patches} patches + {s} tokens) = S {total}, {new} "
        f"new: launches {launches}; first generate {first_s:.3f} s (cold); "
        f"prefill {prefill_s:.3f} s; generate {gen_s:.3f} s -> decode "
        f"{decode_ms:.2f} ms/token-step ({b * new / gen_s:.1f} tokens/s, "
        f"{b * total / prefill_s:,.0f} prompt positions/s in prefill); peak "
        f"memory {peak / 2**30:.2f} GiB; tokens[0] {out[0].tolist()}; "
        "repeat run equal")
    cache = get_model(cfg).init_cache(cfg, b, total + 1)
    wall, cats = device_breakdown(
        torch, lambda: make_prefill(cfg)(model, batch, cache))
    _log_breakdown(f"prefill B={b} S={total}", wall, cats)
    plain = cfg.replace(attn_impl="plain", kernel_impl="torch")
    cache = get_model(plain).init_cache(plain, b, total + 1)
    ref_logits, _ = make_prefill(plain)(model, batch, cache)
    diff = (logits.float() - ref_logits.float()).abs().max().item()
    agree = (logits.float().argmax(-1) == ref_logits.float().argmax(-1)
             ).float().mean().item()
    log(f"full depth, bf16: kernel vs plain-version prefill logits max "
        f"|diff| {diff:.3e} (informative; logit scale "
        f"{ref_logits.float().abs().max().item():.2f}); next-token argmax "
        f"agrees on {agree:.0%} of the prompts")
    del model
    return launches, dict(b=b, s=total, new=new, prefill_s=prefill_s,
                          generate_s=gen_s, decode_ms=decode_ms,
                          tokens_per_s=b * new / gen_s, peak_bytes=peak,
                          plain_logit_diff=diff)


def _host_us(torch, fn, reps=200):
    """Host microseconds of one call of ``fn``: ``reps`` calls enqueued
    back to back on the host clock (no synchronize inside), after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _device_ms(torch, fn, name, reps=20):
    """Mean device time of one launch of the kernels whose name holds
    ``name`` over ``reps`` calls of ``fn`` (``torch.profiler``), None if
    the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if name in ev.key:
            t = getattr(ev, "device_time_total", None)
            total += ev.cuda_time_total if t is None else t
            count += ev.count
    return total / count * 1e-3 if count else None


@contextlib.contextmanager
def earlier_grouped_kernel(path):
    """Runs ``grouped_mm.grouped_matmul`` (the same Python wrapper, checks
    and counters) on the grouped kernel's earlier design, the library built
    from ``yardsticks/``, for the duration of the block."""
    from repro_torch.kernels import grouped_mm

    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grouped_mm_launch.argtypes = [i, i, p, p, p, p] + [i] * 5 + [p]
    lib.grouped_mm_launch.restype = i
    lib.grouped_mm_error_string.argtypes = [i]
    lib.grouped_mm_error_string.restype = ctypes.c_char_p
    saved = grouped_mm._lib
    grouped_mm._lib = lambda: lib
    try:
        yield
    finally:
        grouped_mm._lib = saved


def lm_timing_phase(torch, np, cfg, model, yardstick_lib):
    """LM-d: CUDA-event times at the LM-c and LM-e shapes: one layer's flash
    call on a granite B=8 x 2048 prefill and on a phi-3-vision B=2 x 1600
    prefill (head dim 96), the grouped call at block_t 128 (that prefill)
    and at 8 (a B=8 decode step), each beside its plain version, a library
    yardstick and the card's bound; the grouped calls also beside the
    kernel's earlier design (built from ``yardsticks/``) in turns, with
    the device time (``torch.profiler``) and the host microseconds of one
    call of both."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    phase("LM-d timing at the LM-c and LM-e shapes (CUDA events)")
    rng = np.random.default_rng(2)
    rows = {}

    def row(name, kern, plain, library, lib_label, flops, nbytes, reps,
            note):
        p1 = _time_ms(torch, plain, max(2, reps // 10))
        k1 = _time_ms(torch, kern, reps)
        k2 = _time_ms(torch, kern, reps)
        p2 = _time_ms(torch, plain, max(2, reps // 10))
        lib_ms = _time_ms(torch, library, reps)
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        ms = (k1 + k2) / 2
        log(f"{name} ({note}): kernel {k1:.4f} / {k2:.4f} ms  plain "
            f"{p1:.4f} / {p2:.4f} ms  library_ms {lib_ms:.4f} ({lib_label})"
            f"  bound {bound:.4f} ms ({by}: {flops / 1e9:.3f} GFLOP at 989 "
            f"TFLOP/s bf16 = {t_ops:.4f} ms vs {nbytes / 1e6:.2f} MB at 3.35 "
            f"TB/s = {t_bytes:.4f} ms) -> {flops / (ms * 1e-3) / 1e12:.1f} "
            f"TFLOP/s, {bound / ms:.1%} of the bound, {ms / lib_ms:.2f}x "
            f"the library time")
        return dict(ms=ms, plain_ms=(p1 + p2) / 2, bound_ms=bound,
                    bound_by=by, library_ms=lib_ms, library=lib_label)

    for key, (b, h, kvh, s, d), note in (
            ("flash_attention", (LM_C_RUNS[0][0], cfg.n_heads,
                                 cfg.n_kv_heads, LM_C_RUNS[0][1], cfg.hd),
             "one layer of granite's prefill"),
            ("flash_attention[phi-3-vision]", (2, 32, 32, 1600, 96),
             "one layer of phi-3-vision's prefill (LM-e)")):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, n, s, d)).astype(np.float32)).cuda().to(torch.bfloat16)
            for n in (h, kvh, kvh))
        kr = k.repeat_interleave(h // kvh, dim=1)
        vr = v.repeat_interleave(h // kvh, dim=1)
        pairs = b * h * s * (s + 1) // 2                # causal (q, k) pairs
        rows[key] = row(
            key,
            lambda q=q, k=k, v=v: ops.attention(q, k, v, impl="cuda"),
            lambda q=q, k=k, v=v: ops.attention(q, k, v, impl="torch"),
            lambda q=q, kr=kr, vr=vr: F.scaled_dot_product_attention(
                q, kr, vr, is_causal=True),
            f"torch SDPA, is_causal, on K/V repeated to {h} heads "
            "beforehand" if h != kvh else "torch SDPA, is_causal",
            4.0 * d * pairs, 2 * (2 * q.numel() + k.numel() + v.numel()),
            20, f"B={b} H={h} KVH={kvh} S={s} D={d} bf16 causal, {note}")
        del q, k, v, kr, vr

    ex = model.layers[0].experts
    for bt_want, (bb, ss), reps in ((128, LM_C_RUNS[0][:2], 20),
                                    (8, (LM_C_RUNS[0][0], 1), 200)):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (bb, ss))).cuda()
        xg, te, bt, real, ids = routed_layout(torch, model, cfg, toks)
        if bt != bt_want:
            raise AssertionError(f"block_t {bt} where {bt_want} was meant")
        w = ex.w_gate
        e = w.shape[0]
        used = int(torch.unique(ids).numel())
        flops = 2.0 * real * w.shape[1] * w.shape[2]
        nbytes = 2 * (real * w.shape[1] + real * w.shape[2]
                      + used * w.shape[1] * w.shape[2])
        # torch._grouped_mm's offs: expert k's rows end where its last tile
        # ends (the tail tiles belong to expert E - 1); host bounds read
        # once, outside the timing, as for the per-expert yardstick
        tes = te.cpu().numpy()
        offs = torch.from_numpy((np.searchsorted(
            tes, np.arange(e), side="right") * bt).astype(np.int32)).cuda()
        segs = [(int(x), i * bt, (i + n) * bt) for x, i, n in zip(
            *np.unique(tes, return_index=True),
            np.unique(tes, return_counts=True)[1])]

        def kern(xg=xg, te=te, bt=bt):
            return ops.grouped_matmul(xg, te, w, block_t=bt, impl="cuda")

        def library(xg=xg, offs=offs):
            return torch._grouped_mm(xg, w, offs=offs)

        def per_expert(xg=xg, segs=segs):
            return [torch.matmul(xg[a:z], w[x]) for x, a, z in segs]

        lib_err = (library().float() - kern().float()).abs().max().item()
        if not lib_err <= GROUPED_TOL["bfloat16"]:
            raise AssertionError(f"torch._grouped_mm disagrees with the "
                                 f"kernel by {lib_err}: not the same work")
        key = f"grouped_matmul[block_t={bt}]"
        rows[key] = r = row(
            key, kern,
            lambda xg=xg, te=te, bt=bt: ops.grouped_matmul(
                xg, te, w, block_t=bt, impl="torch"),
            library, "torch._grouped_mm, offs from tile_expert",
            flops, nbytes, reps,
            f"w_gate d={w.shape[1]} F={w.shape[2]}, {xg.shape[0]} padded "
            f"rows, {real} real (B={bb} x S={ss} x top-{cfg.top_k}), "
            f"{used} experts used")
        r["matmul_per_expert_ms"] = _time_ms(torch, per_expert, reps)
        # the earlier design in turns (earlier, change, change, earlier,
        # twice): back-to-back CUDA-event time and host microseconds
        turns = {"earlier": ([], []), "change": ([], [])}
        for who in ("earlier", "change", "change", "earlier") * 2:
            with (earlier_grouped_kernel(yardstick_lib) if who == "earlier"
                  else contextlib.nullcontext()):
                turns[who][0].append(_time_ms(torch, kern, reps))
                turns[who][1].append(_host_us(torch, kern, 2 * reps))
        with earlier_grouped_kernel(yardstick_lib):
            r["earlier_device_ms"] = _device_ms(torch, kern, "grouped_mm")
        r["device_ms"] = _device_ms(torch, kern, "grouped_mm")
        mean = lambda v: sum(v) / len(v)  # noqa: E731
        r.update(turns_ms=mean(turns["change"][0]),
                 earlier_ms=mean(turns["earlier"][0]),
                 host_us=mean(turns["change"][1]),
                 earlier_host_us=mean(turns["earlier"][1]))
        log(f"{key}: matmul per expert segment ({len(segs)} calls) "
            f"{r['matmul_per_expert_ms']:.4f} ms; in turns with the earlier "
            f"design (mma.sync, yardsticks/), earlier / change: back to "
            f"back {turns['earlier'][0]} / {turns['change'][0]} ms (means "
            f"{r['earlier_ms']:.5f} / {r['turns_ms']:.5f}); host "
            f"{turns['earlier'][1]} / {turns['change'][1]} us per call "
            f"(means {r['earlier_host_us']:.2f} / {r['host_us']:.2f}); "
            f"device {r['earlier_device_ms']} / {r['device_ms']} ms per "
            "launch (torch.profiler)")
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
    _, yardstick_lib = build_phase()
    kstats = new_stats()
    kernel_phase(torch, np, kstats)
    ds, ds1_rows, main_launches = ds1_phase(torch)
    overflow_launches = overflow_phase(ds)
    times = timing_phase(torch, np, ds, kstats)
    dstats, dense_launches, dense_times = dense_phase(torch, np, ds)
    er_tuned_phase(ds, ds1_rows)
    er_faults_phase(ds)
    er_s_launches = er_service_phase(torch, np, ds)
    del ds, ds1_rows
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for f32 matmuls; the f32 plain "
                             "versions and LM-b assume it off")
    lm_errs, lm_cases = lm_kernels_phase(torch, np)
    lm_wiring_phase(torch, np)
    cfg, model, lm_launches, _ = lm_slice_phase(torch, np)
    vlm_launches, vlm_row = lm_vlm_phase(torch, np)
    lm_times = lm_timing_phase(torch, np, cfg, model, yardstick_lib)

    phase("7 summary")
    from repro_torch.kernels.ref import ATTENTION_BAND_TOL, GROUPED_BAND_TOL

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
            er_s_launches=er_s_launches[kname],
            max_abs_err=kstats[kname]["max_abs_err"],
            near_threshold_flips=kstats[kname]["near_flips"],
            compared_cases=kstats[kname]["cases"],
            tolerance=f"exact except cells whose f64 score is within "
                      f"{NEAR} of the threshold",
            **times[kname]))
    summary.append(dict(
        name="pair_scores", route="cuda",
        source="src/repro_torch/csrc/pair_sim.cu",
        replaces="src/repro/kernels/pair_sim.py:164",
        launches=dense_launches,
        path="ops.pair_scores (phase D: the test sweep, kernel_bench's "
             "shapes and the first 16,384 DS1 titles, f32 and bf16); times "
             "on the DS1 case, triangular, 128x128, f32 (bf16_* in bf16)",
        max_abs_err=dstats["max_abs_err"],
        near_threshold_flips=dstats["near_flips"],
        compared_cases=dstats["cases"],
        tolerance=f"{DENSE_TOL['float32']} f32 / {DENSE_TOL['bfloat16']} "
                  f"bf16 on cells both sides keep or drop; a cell kept by "
                  f"one side only must score within {NEAR} of the threshold",
        **dense_times["float32"],
        **{f"bf16_{k}": v for k, v in dense_times["bfloat16"].items()}))
    flash = lm_times["flash_attention"]
    phi3 = lm_times["flash_attention[phi-3-vision]"]
    summary.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:125",
        launches=lm_launches["flash_attention"],
        launches_phi3=vlm_launches["flash_attention"],
        path="LM-c generate, granite-moe prefill (attn_impl=kernel); "
             "launches_phi3: LM-e generate, phi-3-vision prefill (head dim "
             "96); times at granite's prefill shape, phi3_* at "
             "phi-3-vision's",
        max_abs_err=lm_errs["flash_attention"],
        max_band_rel_err=lm_errs["flash_band"],
        compared_cases=lm_cases["flash_attention"],
        tolerance=f"{FLASH_TOL['float32']} f32 / {FLASH_TOL['bfloat16']} "
                  "bf16 vs the plain version; max err / max |plain| over "
                  f"64-row bands {ATTENTION_BAND_TOL['float32']} f32 / "
                  f"{ATTENTION_BAND_TOL['bfloat16']} bf16",
        **flash, **{f"phi3_{k}": v for k, v in phi3.items()}))
    pre = lm_times["grouped_matmul[block_t=128]"]
    dec = lm_times["grouped_matmul[block_t=8]"]
    summary.append(dict(
        name="grouped_matmul", route="cuda",
        source="src/repro_torch/csrc/grouped_mm.cu",
        replaces="src/repro/kernels/grouped_mm.py:58",
        launches=lm_launches["grouped_matmul"],
        launches_block_t_128=lm_launches["grouped_matmul[block_t=128]"],
        launches_block_t_8=lm_launches["grouped_matmul[block_t=8]"],
        path="LM-c generate, granite-moe MoE FFN (moe_dispatch=grouped); "
             "times at block_t=128 (prefill), decode_* at block_t=8; "
             "earlier_*: the kernel's earlier design (yardsticks/) in turns "
             "in this run",
        max_abs_err=lm_errs["grouped_matmul"],
        max_band_rel_err=lm_errs["grouped_band"],
        compared_cases=lm_cases["grouped_matmul"],
        tolerance=f"{GROUPED_TOL['float32']} f32 / "
                  f"{GROUPED_TOL['bfloat16']} bf16 vs the plain version; "
                  "max err / max |plain| over block_t-row bands "
                  f"{GROUPED_BAND_TOL['float32']} f32 / "
                  f"{GROUPED_BAND_TOL['bfloat16']} bf16",
        **pre, **{f"decode_{k}": v for k, v in dec.items()}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

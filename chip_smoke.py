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

LM serving, granite-moe-1b-a400m (``repro_torch.serve.generate``):

  LM-a kernels — the flash-attention and grouped-matmul kernels against
               their plain versions at the main path's shapes (granite
               prefill and decode, a ragged S, head dims 16/32/64/128, G = 4,
               non-causal; grouped at block_t 128 and 8 with real routing),
               bf16 and f32, within the JAX package's own tolerances;
  LM-b wiring — granite at full width, 2 layers, f32: prefill + 4 greedy
               decode steps on the kernel route against the plain versions
               (logits atol 2e-3 / rtol 1e-2, equal tokens), and
               prefill/decode consistency against ``forward``;
  LM-c slice — granite at full width and depth, bf16, random weights from
               seed 0: ``generate`` on 8 prompts of 2,048 tokens (32 new)
               and 2 of 1,000 (8 new), with the launches of both kernels,
               prefill seconds, decode ms per step, tokens/s and peak
               memory, and the kernel-vs-plain prefill logits at full depth;
  LM-d timing — CUDA-event times of the flash call of one prefill layer and
               of the grouped call at block_t 128 (prefill) and 8 (decode),
               beside the plain versions, a library yardstick and the
               card's bound.

Then 7, the summary. The last two lines of standard output are the kernel
summary and ``{"ok": true, "device": {...}}``. Without a card, or without the repo
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


def _kernel_label(fn):
    """A readable name for a mangled kernel instance and the dynamic shared
    memory its launch asks for."""
    from repro_torch.kernels import flash_attention, pair_sim

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
    m = re.search(r"grouped_mm_(bf16|f32)ILi(\d+)E", fn)
    if m:
        return f"grouped {m.group(1)} block_t={m.group(2)}", 0
    return fn, 0


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
            r"ptxas info\s+: Used (\d+) registers(?:.*?(\d+) bytes smem)?",
            entry["log"])
        for fn, stack, st, ld, regs, smem in blocks:
            label, dyn = _kernel_label(fn)
            log(f"  {name}: {label:<22} regs {regs:>3}  spill st/ld "
                f"{st}/{ld} B  stack {stack} B  static smem {smem or 0} B  "
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
# LM serving: granite-moe-1b-a400m through repro_torch.serve.generate
# ---------------------------------------------------------------------------

GRANITE = "granite-moe-1b-a400m"
PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16 tensor cores
FLASH_TOL = {"float32": 5e-4, "bfloat16": 3e-2}    # tests/test_kernels.py
GROUPED_TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # (the JAX package's own)
LM_B_TOL = dict(atol=2e-3, rtol=1e-2)              # tests/test_arch_smoke.py
LM_C_RUNS = ((8, 2048, 32), (2, 1000, 8))          # (prompts, length, new)
LM_A_FLASH = (  # (B, H, KVH, S, D, causal), each in bf16 and f32
    (8, 16, 8, 2048, 64, True),      # granite prefill (LM-c's first run)
    (2, 16, 8, 1000, 64, True),      # ragged S (LM-c's second run)
    (2, 16, 4, 512, 16, True), (2, 8, 8, 384, 32, True),
    (1, 16, 4, 1024, 128, True),     # G = 4
    (2, 16, 8, 1024, 64, False))


def granite(torch, **over):
    """granite-moe-1b-a400m at full width, random weights from seed 0 on
    the card; ``over`` replaces config fields (depth, dtype, routes)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = get_config(GRANITE).replace(**over)
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
    the main path's shapes; returns per-kernel max |kernel - plain|."""
    from repro_torch.kernels import ops

    phase("LM-a LM kernels vs plain versions (granite prefill/decode shapes)")
    rng = np.random.default_rng(0)
    errs = {"flash_attention": 0.0, "grouped_matmul": 0.0}
    cases = {"flash_attention": 0, "grouped_matmul": 0}

    def normal(shape, dtype, scale=1.0):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).cuda().to(dtype)

    for b, h, kvh, s, d, causal in LM_A_FLASH:
        for name in ("bfloat16", "float32"):
            dt = getattr(torch, name)
            q, k, v = (normal((b, n, s, d), dt) for n in (h, kvh, kvh))
            got = ops.attention(q, k, v, causal=causal, impl="cuda")
            want = ops.attention(q, k, v, causal=causal, impl="torch")
            err = (got.float() - want.float()).abs().max().item()
            log(f"flash {name:<8} B={b} H={h} KVH={kvh} S={s} D={d} "
                f"causal={causal}: max_abs_err {err:.3e} "
                f"(tolerance {FLASH_TOL[name]})")
            if not err <= FLASH_TOL[name]:
                raise AssertionError("flash kernel disagrees with its "
                                     "plain version")
            errs["flash_attention"] = max(errs["flash_attention"], err)
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
                log(f"grouped {name:<8} block_t={bt} rows {x.shape[0]} "
                    f"(real {real}) d={x.shape[1]} {wname} F={w.shape[2]}: "
                    f"max_abs_err {err:.3e} (tolerance {GROUPED_TOL[name]})")
                if not err <= GROUPED_TOL[name]:
                    raise AssertionError("grouped kernel disagrees with its "
                                         "plain version")
                errs["grouped_matmul"] = max(errs["grouped_matmul"], err)
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


def device_breakdown(torch, fn):
    """Run ``fn`` under ``torch.profiler`` (CPU + CUDA activity) and split
    the device's kernel time into the two LM kernels and everything else
    (PyTorch's own kernels, copies): (wall s, {category: device s}). The
    profiler's own cost is in the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cats = {"flash_attention": 0.0, "grouped_matmul": 0.0, "other": 0.0,
            "device_events": 0, "other_by_name": {}}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        key = ("flash_attention" if "flash_" in e.name else
               "grouped_matmul" if "grouped_mm" in e.name else "other")
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


def lm_timing_phase(torch, np, cfg, model):
    """LM-d: CUDA-event times at the LM-c shapes: one layer's flash call on
    a B=8 x 2048 prefill, the grouped call at block_t 128 (that prefill)
    and at 8 (a B=8 decode step), each beside its plain version, a library
    yardstick and the card's bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    phase("LM-d timing at the LM-c shapes (CUDA events)")
    rng = np.random.default_rng(2)
    b, s = LM_C_RUNS[0][:2]
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, s, d)).astype(
        np.float32)).cuda().to(torch.bfloat16) for n in (h, kvh, kvh))
    kr = k.repeat_interleave(h // kvh, dim=1)
    vr = v.repeat_interleave(h // kvh, dim=1)
    pairs = b * h * s * (s + 1) // 2                # causal (q, k) pairs
    flops = 4.0 * d * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
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
            f"TFLOP/s, {bound / ms:.1%} of the bound")
        return dict(ms=ms, plain_ms=(p1 + p2) / 2, bound_ms=bound,
                    bound_by=by, library_ms=lib_ms, library=lib_label)

    rows["flash_attention"] = row(
        "flash_attention",
        lambda: ops.attention(q, k, v, impl="cuda"),
        lambda: ops.attention(q, k, v, impl="torch"),
        lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True),
        f"torch SDPA, is_causal, on K/V repeated to {h} heads beforehand",
        flops, nbytes, 20, f"B={b} H={h} KVH={kvh} S={s} D={d} bf16 causal, "
        "one layer of the prefill")

    ex = model.layers[0].experts
    for bt_want, (bb, ss), reps in ((128, (b, s), 20), (8, (b, 1), 200)):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (bb, ss))).cuda()
        xg, te, bt, real, ids = routed_layout(torch, model, cfg, toks)
        if bt != bt_want:
            raise AssertionError(f"block_t {bt} where {bt_want} was meant")
        w = ex.w_gate
        used = int(torch.unique(ids).numel())
        flops = 2.0 * real * w.shape[1] * w.shape[2]
        nbytes = 2 * (real * w.shape[1] + real * w.shape[2]
                      + used * w.shape[1] * w.shape[2])
        # the yardstick: one torch.matmul per expert segment (host bounds
        # read once, outside the timing)
        tes = te.cpu().numpy()
        segs = [(int(e), i * bt, (i + n) * bt) for e, i, n in zip(
            *np.unique(tes, return_index=True),
            np.unique(tes, return_counts=True)[1])]

        def library(xg=xg, segs=segs, w=w):
            return [torch.matmul(xg[a:z], w[e]) for e, a, z in segs]

        key = f"grouped_matmul[block_t={bt}]"
        rows[key] = row(
            key,
            lambda xg=xg, te=te, bt=bt: ops.grouped_matmul(
                xg, te, w, block_t=bt, impl="cuda"),
            lambda xg=xg, te=te, bt=bt: ops.grouped_matmul(
                xg, te, w, block_t=bt, impl="torch"),
            library, f"torch.matmul per expert segment, {len(segs)} calls",
            flops, nbytes, reps,
            f"w_gate d={w.shape[1]} F={w.shape[2]}, {xg.shape[0]} padded "
            f"rows, {real} real (B={bb} x S={ss} x top-{cfg.top_k}), "
            f"{used} experts used")
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
    del ds
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for f32 matmuls; the f32 plain "
                             "versions and LM-b assume it off")
    lm_errs, lm_cases = lm_kernels_phase(torch, np)
    lm_wiring_phase(torch, np)
    cfg, model, lm_launches, _ = lm_slice_phase(torch, np)
    lm_times = lm_timing_phase(torch, np, cfg, model)

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
    flash = lm_times["flash_attention"]
    summary.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:125",
        launches=lm_launches["flash_attention"],
        path="LM-c generate, granite-moe prefill (attn_impl=kernel)",
        max_abs_err=lm_errs["flash_attention"],
        compared_cases=lm_cases["flash_attention"],
        tolerance=f"{FLASH_TOL['float32']} f32 / {FLASH_TOL['bfloat16']} "
                  "bf16 vs the plain version",
        **flash))
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
             "times at block_t=128 (prefill), decode_* at block_t=8",
        max_abs_err=lm_errs["grouped_matmul"],
        compared_cases=lm_cases["grouped_matmul"],
        tolerance=f"{GROUPED_TOL['float32']} f32 / "
                  f"{GROUPED_TOL['bfloat16']} bf16 vs the plain version",
        **pre, **{f"decode_{k}": v for k, v in dec.items()}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

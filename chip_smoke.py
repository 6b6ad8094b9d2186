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

  D    dense — ``ops.pair_scores`` on the sweep of tests/test_kernels.py,
               kernel_bench's shapes and the first 16,384 featurized DS1
               titles (triangular, 128x128), f32 and bf16, each against its
               plain version (the bf16 wgmma + TMA route at the f32
               tolerance); launches counted on those calls, per route (the
               DS1 and kernel_bench bf16 cases on the wgmma + TMA kernel,
               N 130 and 31 on the FMA kernel); CUDA-event times of the DS1
               case beside the plain version, the library chain
               (``torch.mm`` with ``out_dtype=float32`` in bf16), the
               product alone (``gemm_ms``) and the bound, the bf16 case in
               turns with the earlier design (the FMA kernel);
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

The seventh slice (the mesh, one controller driving every shard):

  ER-m mesh    — ``run_er(mesh=make_er_mesh(1))`` at DS1 for every
               strategy (phase 4's matches, no interconnect bytes); DS1
               PairRange on 8 logical shards of the card
               (``make_er_mesh(8, devices=["cuda:0"] * 8)``) with the flat,
               ring and hierarchical gathers: 7,788 matches each and
               ``stage1_stats["interconnect"]`` equal to the plan's bytes
               per device times the launches, ring below flat; Basic on 8
               shards at ``compact_capacity=4`` (the mask twin on
               overflow); ``match_sn_dist`` over 8 shards + ``verify_pairs``
               (7,715); PairRange on a (4, 2) data × model mesh (phase 4's
               matches but for pairs within NEAR of the threshold, counted);
               ``ERService(mesh=...)`` on 8 shards over ER-s's traffic
               (ER-s's 4,892 matches, no build or load in steady state,
               queries/s and p50/p99 beside ER-s's); the same on 4 shards
               under a fault script of transient errors (the supervisor over
               the gathered corpus: ER-s's matches, its retries and
               recovered tiles). Seconds per run and
               stage-1 kernel seconds beside phase 4's; the launches of the
               whole phase (both catalog kernels must launch).

The tenth slice (the torch legs of ``benchmarks/``):

  BL legs     — every ``benchmarks/torch_*.py`` leg's ``measure`` at
               ``--quick`` sizes on the card (the kernels on the ``cuda``
               route: K1 in the ER legs, K2 in the services' warm-up, K5 on
               both dense routes in kernel_bench), beside the same legs on
               the CPU in two subprocesses (the plain route); every count
               column (each leg's ``counts``) equal on both, the catalog
               survivors but for near-threshold flips that the leg printed
               and held within NEAR; then each leg's ``check`` — its
               wall-time bars — on the card's rows, the legs with bars run
               after the CPU side has finished; the phase's launches. A
               missed wall-time bar is printed with its reading and listed
               in the summary (the leg's own command line fails on it); an
               exact check that fails fails the phase. The mesh legs
               (eleventh slice): ``torch_mesh_bench`` and
               ``torch_fig13_scaling`` at ``--quick`` on 16, 4 x 2, 2 and 4
               logical shards of cuda:0 (the bytes per shard among the
               count columns; the ring bar, 2x below flat at 16 shards,
               fails the phase), then ``torch_mesh_bench`` at its full
               size (8 and 16 shards of 4,000 titles, a (4, 2) mesh of
               2,000) under its own asserts.

The eleventh slice (the torch examples):

  EX examples — each ``examples/torch_*.py``'s ``main`` in-process with
               ``--device cuda``, then ``--device cpu``: the five ER
               examples' returned counts equal on both; ``torch_serve_lm``
               (reduced smollm-360m, 4 x 32 -> 32 tokens at temperature 0.8)
               its shape and token range on both; ``torch_train_lm`` (the
               ~100M config) 20 steps on the card, every loss finite and the
               mean of the last 5 below the first, and 2 finite steps on the
               CPU; the launches of the card runs (K1, and K2 through the
               service's warm-up, must launch); both catalog kernels against
               their plain versions on the chaos drill's 64 x 64 catalog at
               width 64.

LM serving, granite-moe-1b-a400m (``repro_torch.serve.generate``):

  LM-a kernels — the flash-attention and grouped-matmul kernels against
               their plain versions at the main path's shapes (granite
               prefill and decode, phi-3-vision's and zamba2-2.7b's
               prefills, a ragged S, head dims 16/32/64/80/96/128, G = 1 to
               4, non-causal, scales -0.125 and
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

The eighth slice (training, and the ssm / hybrid / audio families):

  T-a train  — three train steps (``repro_torch.train.make_train_step``,
               AdamW lr 1e-3) on the card against the same three on the
               CPU from the same weights, f32, TF32 off: smollm-360m and
               granite-moe-1b-a400m (gshard: the router aux loss's
               gradient) at full width, 2 layers, B 2 x S 128 (metrics
               rtol 1e-4, aux atol 1e-6, params atol 1e-5);
  T-b slice  — smollm-360m at full width and depth, bf16, remat, random
               weights from seed 0, through ``repro_torch.launch.train``:
               40 steps of 8 x 1,024 tokens with async checkpoints every
               20, every loss finite and the mean of the last 5 below the
               first; the checkpoint of step 40 equal to the run's state in
               memory bit for bit; step ms, tokens/s, peak memory and the
               device busy share (median of 5 steps, ``torch.profiler``);
               then ``main(--steps 50)``, which must resume from step 40;
  LM-f families — zamba2-2.7b on the flash route (head dim 80): 12 layers
               f32 against the plain route (prefill + 4 decode steps, LM-b's
               tolerance, one flash launch per super-block), then full
               width and depth, bf16, ``generate`` on 2 x 1,024 tokens (8
               new; 9 flash launches, the kernel-vs-plain prefill logits);
               rwkv6-7b: 2 layers f32 on the card against the CPU, then
               full bf16 ``generate`` on 2 x 512 (8 new); whisper-base on
               the plain route, full bf16, 2 x (1,500 stub frames + 64
               tokens) (8 new), and its kernel route raising ValueError.
               Prefill s, decode ms per step, tokens/s, peak memory; two
               greedy runs must agree.

The ninth slice (the cell harness: ``repro_torch.launch.steps`` and the
dry-run's roofline with H100 data-sheet constants):

  DR cells   — ``steps.build_cell(device="cuda")`` on the one-card test
               mesh at full width and depth, bf16, random weights from seed
               0, each global batch cut to one card's share (logged): DR-1
               smollm-360m x train_4k (256 -> 2; one warm-up and three
               timed steps, plain routes), DR-2 qwen3-4b x prefill_32k
               (32 -> 1; one timed step on the plain route, then three on
               the flash kernel route, S 32,768, D 128: the same next
               token), DR-3 granite-moe-1b-a400m x decode_32k (128 -> 8, a
               32k cache at pos 32,767; ten timed steps on the plain /
               gshard routes, then ten on the grouped + kernel routes, in
               bf16, their next tokens compared; then the same cell in f32,
               where the grouped + kernel route must give drop-free
               gshard's next tokens and logits). Per cell: the step time (host clock ending
               in a synchronize), ``max_memory_allocated`` and the MFU
               (model FLOPs / (989 TFLOP/s x step)), beside
               ``dryrun.run_cell``'s prediction for the same cut cell on the
               same mesh (step, bottleneck, the three terms, peak live +
               argument bytes) and the ratios measured / predicted.

Phases run in the order 1-6, D, ER-t, ER-f, ER-s, ER-m, BL, EX, LM-a, LM-b, LM-c,
LM-e, LM-d, T-a, T-b, LM-f, DR, then 7, the
summary. The last two lines of standard output are the kernel
summary and ``{"ok": true, "device": {...}}``. Without a card, or without the repo
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
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
    m = re.search(r"dense_scores_tmaILi(\d+)ELi(\d+)E", fn)
    if m:
        sm, sn = int(m.group(1)), int(m.group(2))
        return (f"dense tma bf16 sub-tile {sm}x{sn}",
                pair_sim.dense_tma_smem_bytes(sm, sn))
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
                                 "grouped decode", "dense tma")) \
                    or "128x128" in label:
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
    dlib = pair_sim._dense_lib()
    for bm, bn in pair_sim.GEOMETRY_LATTICE:
        got = dlib.dense_scores_smem_bytes(bm, bn)
        want = pair_sim.dense_tma_smem_bytes(bm, bn) if bm >= 64 else -1
        if got != want:
            raise AssertionError(f"dense TMA shared-memory model disagrees "
                                 f"with the kernel at ({bm}, {bn}): {got}")
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
        "the bf16 TMA dense kernel's lattice, flash at every head dim, "
        "every TMA-fed grouped kernel)")
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

def stats_snapshot():
    """A copy of ``stage1_stats``, its per-flow interconnect counters
    included."""
    from repro_torch.er import stage1_stats
    return {k: dict(v) if isinstance(v, dict) else v
            for k, v in stage1_stats.items()}


def stats_delta(before):
    """``stage1_stats`` minus a :func:`stats_snapshot`, flow by flow."""
    now = stats_snapshot()
    return {k: ({f: n - before[k].get(f, 0) for f, n in v.items()}
                if isinstance(v, dict) else v - before[k])
            for k, v in now.items()}


def ds1_phase(torch):
    from repro_torch.er import ERConfig, make_products, run_er
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
        before = stats_snapshot()
        ops.reset_launch_counts()
        res = run_er(ds.titles, ERConfig(strategy=strategy), device="cuda")
        counts = ops.launch_counts()
        s1 = stats_delta(before)
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
    from repro_torch.er import ERConfig, run_er
    from repro_torch.kernels import ops

    phase("5 overflow: pair_range at DS1 with compact_capacity=16")
    before = stats_snapshot()
    ops.reset_launch_counts()
    res = run_er(ds.titles, ERConfig(compact_capacity=16), device="cuda")
    counts = ops.launch_counts()
    s1 = stats_delta(before)
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
            ad = a.to(dt).contiguous()
            # a self-join stays one tensor in the working type too
            bd = ad if b is a else b.to(dt).contiguous()
            out.append((f"{label} {name}", ad, bd, thr, tri, geo, name))
    return out


def _dense_check(torch, a, b, got, want, thr, tol, label):
    """Kernel vs plain version: a cell kept by one side only must have an
    f64 score within NEAR of the threshold; cells both keep (or both drop)
    agree within ``tol``. Returns (max |diff| over those cells, flips,
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
    if not err <= tol:
        raise AssertionError(f"dense kernel: {label} max |diff| {err} > "
                             f"{tol}")
    return err, flips, int((got != 0).sum())


def _dense_routes(pair_sim, cases):
    """Each case's route (``pair_sim.dense_route``), held to the rule: the
    DS1 and kernel_bench bf16 cases on the wgmma + TMA kernel, the bf16
    sweep cases whose N TMA cannot address (130, 31) on the FMA kernel,
    every f32 case on the FMA kernel."""
    routes = []
    for label, a, b, _, _, geo, name in cases:
        route = pair_sim.dense_route(a, b, *geo)
        want = None
        if name == "float32" or b.shape[0] in (130, 31):
            want = "fma"
        elif "DS1" in label or "kernel_bench" in label:
            want = "tma"
        if want is not None and route != want:
            raise AssertionError(f"{label}: route {route}, expected {want}")
        routes.append(route)
    return routes


def dense_phase(torch, np, ds):
    """D: the dense kernels through ``ops.pair_scores`` on every case (the
    main path: launches counted here, per route), each held against the
    plain version; then CUDA-event times of the large DS1 case, the bf16
    one in turns with the earlier design (the FMA kernel)."""
    from repro_torch.kernels import ops, pair_sim, ref

    phase("D dense pair_scores kernels vs plain version "
          "(ops.pair_scores, src/repro/kernels/pair_sim.py:164)")
    cases = _dense_cases(torch, np, ds)
    routes = _dense_routes(pair_sim, cases)
    stats = {"cases": 0, "near_flips": 0, "max_abs_err": 0.0,
             "tma_cases": 0, "tma_max_abs_err": 0.0}
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    outs = [ops.pair_scores(a, b, threshold=thr, triangular=tri,
                            block_m=geo[0], block_n=geo[1], impl="auto")
            for _, a, b, thr, tri, geo, _ in cases]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    launches = {r: counts[f"pair_scores[{r}]"]
                for r in pair_sim.DENSE_ROUTES}
    launches["all"] = counts["pair_scores"]
    want = {r: routes.count(r) for r in pair_sim.DENSE_ROUTES}
    if launches["all"] != len(cases) or any(
            launches[r] != want[r] for r in want):
        raise AssertionError(f"pair_scores launches {launches} for "
                             f"{len(cases)} calls, routes {want}")
    for (label, a, b, thr, tri, geo, name), route, got in zip(cases, routes,
                                                            outs):
        want_out = ops.pair_scores(a, b, threshold=thr, triangular=tri,
                                   impl="torch")
        # bf16 products are exact in f32, so the wgmma route is held to
        # the f32 tolerance
        tol = DENSE_TOL["float32" if route == "tma" else name]
        err, flips, kept = _dense_check(torch, a, b, got, want_out, thr,
                                        tol, f"{label} [{route}]")
        if tri and bool(got.tril().any()):
            raise AssertionError(f"dense kernel kept a cell on or below "
                                 f"the diagonal: {label}")
        stats["cases"] += 1
        stats["near_flips"] += flips
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        if route == "tma":
            stats["tma_cases"] += 1
            stats["tma_max_abs_err"] = max(stats["tma_max_abs_err"], err)
        if "DS1" in label or "kernel_bench" in label:
            log(f"{label}: route {route}, kept {kept} cells, max |kernel - "
                f"plain| {err:.3e} (tolerance {tol}), {flips} "
                f"near-threshold flips")
        del want_out
    del outs
    log(f"{stats['cases']} cases equal to the plain version: "
        f"{stats['tma_cases']} on the bf16 wgmma + TMA route within "
        f"{DENSE_TOL['float32']} (max {stats['tma_max_abs_err']:.3e}), the "
        f"rest on the FMA route within {DENSE_TOL['float32']} f32 / "
        f"{DENSE_TOL['bfloat16']} bf16 (cells kept by one side only: "
        f"{stats['near_flips']}, each within {NEAR} of the threshold); "
        f"main-path launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")

    rows = {}
    for (label, a, b, thr, tri, geo, name), route in zip(cases, routes):
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

        def earlier(a=a, b=b, thr=thr, tri=tri, geo=geo):
            """The FMA kernel at the same shape, launched without the
            wrapper's counters (a timing yardstick, not the main path)."""
            out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.float32,
                              device=a.device)
            pair_sim._launch_dense("fma", a, b, out, thr, tri, *geo)
            return out

        def gemm(a=a, b=b):
            if a.dtype == torch.bfloat16:
                return torch.mm(a, b.T, out_dtype=torch.float32)
            with ref.full_precision():
                return torch.matmul(a, b.T)

        def library(thr=thr, gemm=gemm):
            s = gemm()
            return torch.where(s >= thr, s, 0.0).triu(1)

        row = {}
        if route == "tma":
            # the earlier design and the library chain compute the same
            # function: each held to the kernel's output once (the library's
            # sums run in cuBLAS's order, so a few cells at the threshold
            # may flip)
            k_out = kern()
            e_err, e_flips, _ = _dense_check(
                torch, a, b, earlier(), k_out, thr, DENSE_TOL["float32"],
                f"{label}: earlier design vs kernel")
            lib_out = library()
            flip = (lib_out == 0) != (k_out == 0)
            l_err = (lib_out - k_out).abs().masked_fill_(flip, 0).max().item()
            l_flips = int(flip.sum())
            if not (l_err <= DENSE_TOL["bfloat16"] and l_flips <= 16):
                raise AssertionError(f"{label}: the library chain is not the "
                                     f"same function: max |diff| {l_err}, "
                                     f"{l_flips} flips")
            log(f"{label}: earlier design vs kernel max |diff| {e_err:.3e} "
                f"({e_flips} near-threshold flips); library chain vs kernel "
                f"{l_err:.3e} ({l_flips} flips)")
            del k_out, lib_out, flip
            p1 = _time_ms(torch, plain, 3)
            e1 = _time_ms(torch, earlier, 5)
            k1 = _time_ms(torch, kern, 10)
            k2 = _time_ms(torch, kern, 10)
            e2 = _time_ms(torch, earlier, 5)
            p2 = _time_ms(torch, plain, 3)
            row["earlier_ms"] = (e1 + e2) / 2
            # the card's write floor for the same output bytes, and the
            # kernel with b a second copy of a (16 MB of operands in L2)
            buf = torch.empty((n, n), dtype=torch.float32, device=a.device)
            row["fill_ms"] = _time_ms(torch, lambda: buf.fill_(0.0), 10)
            del buf
            b2 = b.clone()
            row["two_copies_ms"] = _time_ms(
                torch, lambda: kern(a, b2), 10)
            del b2
            earlier_log = (f"  earlier design (FMA kernel) {e1:.4f} / "
                           f"{e2:.4f} ms in turns  fill_ of the output "
                           f"{row['fill_ms']:.4f} ms  b a second copy of a "
                           f"{row['two_copies_ms']:.4f} ms")
        else:
            p1 = _time_ms(torch, plain, 3)
            k1 = _time_ms(torch, kern, 5)
            k2 = _time_ms(torch, kern, 5)
            p2 = _time_ms(torch, plain, 3)
            earlier_log = ""
        lib_ms = _time_ms(torch, library, 5)
        gemm_ms = _time_ms(torch, gemm, 5)
        ms = (k1 + k2) / 2
        rows[name] = dict(ms=ms, plain_ms=(p1 + p2) / 2, bound_ms=bound,
                          bound_by=by, library_ms=lib_ms, gemm_ms=gemm_ms,
                          route=route, **row)
        lib_what = ("torch.mm(a, b.T, out_dtype=float32)"
                    if name == "bfloat16" else "torch.matmul in f32, TF32 off")
        log(f"{label}: route {route}, kernel {k1:.4f} / {k2:.4f} ms"
            f"{earlier_log}  plain {p1:.3f} / {p2:.3f} ms  library_ms "
            f"{lib_ms:.4f} ({lib_what}, then where and triu(1))  gemm_ms "
            f"{gemm_ms:.4f} (the product alone)  bound {bound:.4f} ms ({by}:"
            f" {flops / 1e9:.2f} GFLOP at {peak / 1e12:.0f} TFLOP/s = "
            f"{t_ops:.4f} ms vs {nbytes / 1e9:.3f} GB at 3.35 TB/s = "
            f"{t_bytes:.4f} ms) -> {flops / (ms * 1e-3) / 1e12:.2f} "
            f"TFLOP/s, {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s, "
            f"{bound / ms:.1%} of the bound, {ms / lib_ms:.2f}x the library "
            f"time")
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
    return launches, {"served": served, "batches": batches,
                      "qps": len(queries) / total_s,
                      "p50": float(np.percentile(ms_a, 50)),
                      "p99": float(np.percentile(ms_a, 99))}


# ---------------------------------------------------------------------------
# ER-m: the mesh at DS1
# ---------------------------------------------------------------------------

ER_M_SHARDS = 8
ER_M_F3_SHARDS = 4             # the sharded service under a fault script
ER_M_F3_STEPS = (0, 7, 40)     # shard-call steps of its transient faults


def _mesh_run(ds, cfg, mesh, label, want):
    """One ``run_er(mesh=...)`` at DS1: (result, its stage1_stats delta,
    its launches, wall seconds); raises unless the matches equal
    ``want``."""
    from repro_torch.er import run_er
    from repro_torch.kernels import ops

    before = stats_snapshot()
    counts0 = ops.launch_counts()
    t0 = time.perf_counter()
    res = run_er(ds.titles, cfg, mesh=mesh, device="cuda")
    wall = time.perf_counter() - t0
    s1 = stats_delta(before)
    counts = {k: v - counts0[k] for k, v in ops.launch_counts().items()}
    if want is not None and res.matches != want:
        raise AssertionError(f"{label}: {len(res.matches)} matches differ "
                             f"from phase 4's {len(want)}")
    return res, s1, counts, wall


def _flows(s1):
    return {k: v for k, v in s1["interconnect"].items() if v}


def er_mesh_phase(torch, np, ds, ds1_rows, er_s):
    """ER-m: ``run_er(mesh=...)`` at DS1 on ``make_er_mesh(1)`` for every
    strategy, then on 8 logical shards of the card for every comms
    policy (and an overflow run through the mask twin), ``match_sn_dist``
    over 8 shards, PairRange on a (4, 2) data × model mesh, and
    ``ERService(mesh=...)`` on ER-s's traffic. Returns the launches of the
    whole phase."""
    from repro_torch.er import (ERConfig, ERService, ServiceConfig,
                                compile_counter, featurize, sn_sort_order)
    from repro_torch.er.compiler import (FaultEvent, FaultInjector,
                                         FaultScript, plan_comms,
                                         verify_pairs)
    from repro_torch.er.distributed import match_sn_dist
    from repro_torch.kernels import ops
    from repro_torch.sharding import make_er_mesh

    phase(f"ER-m the mesh: run_er / match_sn_dist / ERService on "
          f"make_er_mesh(1) and on {ER_M_SHARDS} logical shards of cuda:0")
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    one = make_er_mesh(1)
    for strategy in STRATEGIES:
        base, _ = ds1_rows[strategy]
        res, s1, counts, wall = _mesh_run(
            ds, ERConfig(strategy=strategy), one, strategy, base.matches)
        if _flows(s1):
            raise AssertionError(f"{strategy}: a 1-shard mesh counted "
                                 f"interconnect bytes {_flows(s1)}")
        tm, tb = res.extra["timings"], base.extra["timings"]
        log(f"[mesh 1 {strategy}] matches {len(res.matches)} (phase 4: "
            f"equal), interconnect 0; run {wall:.3f} s (phase 4 total "
            f"{tb['total_s']:.3f} s), stage-1 kernel {tm['stage1_s']:.4f} "
            f"s (phase 4: {tb['stage1_s']:.4f} s); launches {counts}")

    mesh8 = make_er_mesh(ER_M_SHARDS, devices=["cuda:0"] * ER_M_SHARDS)
    pr_base = ds1_rows["pair_range"][0]
    rows_p = -(-len(ds.titles) // (ER_M_SHARDS * 128)) * ER_M_SHARDS * 128
    totals = {}
    for comms in ("flat", "ring", "hierarchical"):
        res, s1, counts, wall = _mesh_run(
            ds, ERConfig(comms=comms), mesh8, f"8 shards {comms}",
            pr_base.matches)
        if "comms_fallback" in res.extra:
            raise AssertionError(f"{comms}: plan fell back to flat: "
                                 f"{res.extra['comms_fallback']}")
        # (a flat plan reads no tile, hence no catalog)
        per = (res.schedule["interconnect"]["bytes_received_per_device"]
               if comms != "flat" else
               plan_comms(None, rows_p, ER_M_SHARDS, policy="flat",
                          feature_dim=256).bytes_received_per_device())
        launches = counts["pair_scores_catalog_compact"] // ER_M_SHARDS
        names = {"flat": {"flat_bytes": "flat_gather"},
                 "ring": {"ring_bytes": "ring"},
                 "hierarchical": {"hier_intra_bytes": "hier_intra",
                                  "hier_inter_bytes": "hier_inter"}}[comms]
        want = {k: per[f] * launches for k, f in names.items()
                if per[f] * launches}
        if _flows(s1) != want or launches == 0:
            raise AssertionError(f"{comms}: interconnect {_flows(s1)} != "
                                 f"plan bytes {per} x {launches} launches")
        totals[comms] = per["total"]
        tm = res.extra["timings"]
        hops = {k: v for k, v in res.schedule.get("interconnect", {}).items()
                if k in ("hops", "group", "inter_hops")}
        log(f"[mesh 8 {comms}] matches {len(res.matches)} (equal); plan "
            f"{hops or 'flat'}, bytes received per device per launch "
            f"{per}; interconnect "
            f"{_flows(s1)} = plan x {launches} launches; run {wall:.3f} s, "
            f"stage-1 kernel {tm['stage1_s']:.4f} s, decode "
            f"{tm['decode_s']:.4f} s (phase 4: "
            f"{pr_base.extra['timings']['stage1_s']:.4f} s); launches "
            f"{counts}")
    if not totals["ring"] < totals["flat"]:
        raise AssertionError(f"ring bytes {totals['ring']} not below flat "
                             f"{totals['flat']}")
    log(f"ring / flat bytes per device per launch: {totals['ring']} / "
        f"{totals['flat']} = {totals['ring'] / totals['flat']:.4f}; "
        f"hierarchical {totals['hierarchical']}")

    basic = ds1_rows["basic"][0]
    res, s1, counts, wall = _mesh_run(
        ds, ERConfig(strategy="basic", compact_capacity=4), mesh8,
        "8 shards overflow", basic.matches)
    if not (s1["compact_overflows"] > 0 and counts["pair_scores_catalog"]):
        raise AssertionError(f"overflow did not reach the mask twin: {s1}")
    log(f"[mesh 8 basic compact_capacity=4] matches {len(res.matches)} "
        f"(equal); overflows {s1['compact_overflows']}, mask-twin chunks "
        f"{s1['nonzero_decodes']}; launches {counts}; {wall:.3f} s")

    # RepSN over 8 shards: the sorted features zero-padded to a multiple
    # of 8 rows (a zero row scores 0 against every row, so it never
    # survives stage 1 and the band between real rows is unchanged).
    cfg = ERConfig(strategy="sorted_neighborhood")
    t0 = time.perf_counter()
    codes, lens, feats = featurize(ds.titles, cfg)
    order = sn_sort_order(ds.titles)
    n = len(order)
    fs = np.zeros((-(-n // ER_M_SHARDS) * ER_M_SHARDS, feats.shape[1]),
                  np.float32)
    fs[:n] = feats[order]
    before = stats_snapshot()
    counts0 = ops.launch_counts()
    ca, cb = match_sn_dist(fs, cfg.window, mesh8,
                           threshold=cfg.threshold - cfg.filter_margin)
    ha, hb = verify_pairs(codes[order], lens[order], codes[order],
                          lens[order], ca, cb, cfg.threshold, device="cuda")
    s1 = stats_delta(before)
    counts = {k: v - counts0[k] for k, v in ops.launch_counts().items()}
    got = {(min(int(order[a]), int(order[b])),
            max(int(order[a]), int(order[b]))) for a, b in zip(ha, hb)}
    sn_base = ds1_rows["sorted_neighborhood"][0].matches
    if got != sn_base or len(got) != DS1_SN_MATCHES:
        raise AssertionError(f"match_sn_dist: {len(got)} matches, phase 4 "
                             f"SN {len(sn_base)}")
    log(f"[match_sn_dist 8 shards] {len(got)} matches (phase 4 SN: equal); "
        f"halo bytes {_flows(s1)}; launches {counts}; "
        f"{time.perf_counter() - t0:.3f} s with featurize and stage 2")

    mesh42 = make_er_mesh(4, 2, devices=["cuda:0"] * 8)
    res, s1, counts, wall = _mesh_run(ds, ERConfig(), mesh42, "(4, 2)",
                                      None)
    diff = res.matches ^ pr_base.matches
    if diff:
        _, _, fg = featurize(ds.titles, ERConfig())
        thr = float(np.float32(0.8 - 0.25))
        for i, j in sorted(diff):
            sc = float(np.dot(fg[i].astype(np.float64),
                              fg[j].astype(np.float64)))
            log(f"  (4, 2) differs on ({i}, {j}): f64 stage-1 score {sc!r}")
            if abs(sc - thr) > NEAR:
                raise AssertionError("(4, 2) mesh differs off the "
                                     "threshold")
    tm = res.extra["timings"]
    log(f"[mesh (4, 2) pair_range] matches {len(res.matches)}; {len(diff)} "
        f"pairs differ from phase 4 (each within {NEAR} of the stage-1 "
        f"threshold); interconnect {_flows(s1)}; run {wall:.3f} s, stage-1 "
        f"{tm['stage1_s']:.4f} s (K6 plain bmm + psum + epilogue); launches "
        f"{counts}")

    corpus = list(ds.titles)
    batches = er_s["batches"]
    queries = [q for b in batches for q in b]
    t0 = time.perf_counter()
    svc = ERService(corpus, ServiceConfig(), mesh=mesh8, device="cuda")
    ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc.warmup()
    warm_s = time.perf_counter() - t0
    before = stats_snapshot()
    with compile_counter() as steady:
        responses, ms = _serve(svc, batches)
    s1 = stats_delta(before)
    if steady.count != 0:
        raise AssertionError(f"mesh service: {steady.count} builds/loads in "
                             f"steady state")
    served = _union(responses, batches)
    if served != er_s["served"]:
        raise AssertionError(f"mesh service: {len(served)} matches, ER-s "
                             f"{len(er_s['served'])}")
    ms_a = np.asarray(ms)
    qps = len(queries) / (ms_a.sum() / 1e3)
    log(f"[ERService mesh {ER_M_SHARDS} shards] streaming == batch: "
        f"{len(served)} cross matches, equal to ER-s's; 0 builds/loads in "
        f"steady state; ingest {ingest:.3f} s, warmup {warm_s:.3f} s; "
        f"{qps:.1f} queries/s, p50 {np.percentile(ms_a, 50):.2f} ms, p99 "
        f"{np.percentile(ms_a, 99):.2f} ms (ER-s single device: "
        f"{er_s['qps']:.1f} queries/s, p50 {er_s['p50']:.2f} ms, p99 "
        f"{er_s['p99']:.2f} ms); interconnect {_flows(s1)}")
    del svc

    # F3: a sharded-index service takes a fault injector; the supervisor
    # scores the gathered corpus, and the answer is ER-s's.
    svc = ERService(corpus, ServiceConfig(backoff_s=0.0),
                    mesh=make_er_mesh(ER_M_F3_SHARDS,
                                      devices=["cuda:0"] * ER_M_F3_SHARDS),
                    device="cuda")
    svc.warmup()
    svc.set_fault_injector(FaultInjector(FaultScript(events=tuple(
        FaultEvent("transient", 0, step) for step in ER_M_F3_STEPS),
        n_dev=1)))
    t0 = time.perf_counter()
    responses, ms = _serve(svc, batches)
    served = _union(responses, batches)
    st = svc.stats
    if served != er_s["served"]:
        raise AssertionError(f"mesh service under faults: {len(served)} "
                             f"matches, ER-s {len(er_s['served'])}")
    if not st["retries"] or not st["recovered_tiles"] or st["degraded"]:
        raise AssertionError(f"mesh service under faults: {st}")
    log(f"[ERService mesh {ER_M_F3_SHARDS} shards + FaultScript(transient "
        f"at steps {ER_M_F3_STEPS})] {len(served)} cross matches, equal to "
        f"ER-s's (the unsharded service); retries {st['retries']}, "
        f"recovered tiles {st['recovered_tiles']}, degraded {st['degraded']};"
        f" p50 {np.percentile(np.asarray(ms), 50):.2f} ms; "
        f"{time.perf_counter() - t0:.3f} s")
    del svc
    launches = ops.launch_counts()
    for k in ("pair_scores_catalog_compact", "pair_scores_catalog"):
        if launches[k] == 0:
            raise AssertionError(f"ER-m launched no {k}")
    log(f"ER-m launches {launches}; {time.perf_counter() - t_phase:.1f} s")
    return launches

# ---------------------------------------------------------------------------
# BL: the torch legs of benchmarks/ on the card
# ---------------------------------------------------------------------------

# (label, module under benchmarks/, measure, check, count view): every leg
# but the catalog half of kernel_bench under its own name.
BL_LEGS = tuple(
    (label, f"torch_{label}", "measure", "check", "counts") for label in (
        "fig9_skew", "fig10_reduce_tasks", "fig11_sorted", "fig_sn_window",
        "fig8_datasets", "fig12_map_output", "schedule_bench", "chaos_bench",
        "kernel_bench", "mesh_bench", "fig13_scaling", "serve_bench",
        "tune_bench", "steal_bench")) + (
    ("kernel_bench_catalog", "torch_kernel_bench", "measure_catalog",
     "check_catalog", "catalog_counts"),)
BL_BARS = ("kernel_bench_catalog", "serve_bench", "tune_bench",
           "steal_bench")      # wall-time bars: measured after the CPU side
BL_CPU_THREADS = 3             # per CPU process; two run side by side:
BL_CPU_SECOND = ("fig10_reduce_tasks", "fig11_sorted", "serve_bench",
                 "tune_bench", "steal_bench")
BL_CPU_SCRIPT = """
import importlib, json, sys, time
import torch
import benchmarks.common as common
out, threads = sys.argv[1], int(sys.argv[2])
torch.set_num_threads(threads)
common.OUT_DIR = out
for spec in sys.argv[3:]:
    label, module, fn = spec.split(":")
    t0 = time.perf_counter()
    rows = getattr(importlib.import_module("benchmarks." + module), fn)(
        quick=True, device="cpu")
    with open(f"{out}/{label}.rows.json", "w") as f:
        json.dump({"rows": rows, "seconds": time.perf_counter() - t0}, f,
                  default=float)
    print(f"[cpu] {label}: {time.perf_counter() - t0:.1f} s", flush=True)
"""


def _bl_near_ok(mod, card, cpu, card_view, cpu_view):
    """Card and CPU count views that differ only in a column the leg lets
    differ by its near-threshold flips (``NEAR_COLUMNS``): True when every
    such difference is within the flips both sides counted (each flip was
    printed, and held within NEAR of the threshold, by the leg)."""
    near = getattr(mod, "NEAR_COLUMNS", {})
    if not near or len(card_view) != len(cpu_view):
        return False
    for i, (a, b) in enumerate(zip(card_view, cpu_view)):
        for col in a:
            if a[col] == b[col]:
                continue
            if col not in near:
                return False
            flips = card[i][near[col]] + cpu[i][near[col]]
            if abs(a[col] - b[col]) > flips:
                return False
    return True


def bl_phase(torch, np):
    """BL: every torch leg of ``benchmarks/`` at ``--quick`` sizes on the
    card (``measure(quick=True, device="cuda")``, the kernels on the
    ``cuda`` route), its count columns held against the same leg on the
    CPU (the plain route, which the CPU tests hold against the JAX legs)
    run in two subprocesses beside it, then each leg's ``check`` (its
    wall-time bars; a missed byte bar, as the mesh leg's, fails) on the
    card's rows, then ``torch_mesh_bench`` at its full size under its own
    asserts. Returns the phase's launches and the missed wall-time bars
    (label -> the check's message)."""
    import importlib
    import shutil
    import benchmarks.common as common
    from repro_torch.kernels import build, ops

    phase("BL the torch legs of benchmarks/ on the card (--quick), held "
          "against the same legs on the CPU")
    t_phase = time.perf_counter()
    out = build.BUILD_DIR / "bl"
    shutil.rmtree(out, ignore_errors=True)
    (out / "cpu").mkdir(parents=True)
    common.OUT_DIR = str(out / "cuda")
    env = dict(os.environ, PYTHONPATH=f"{SRC}:{ROOT}",
               OMP_NUM_THREADS=str(BL_CPU_THREADS))
    cpu_logs = [open(out / f"cpu{i}.log", "w") for i in range(2)]
    cpus = [subprocess.Popen(
        [sys.executable, "-c", BL_CPU_SCRIPT, str(out / "cpu"),
         str(BL_CPU_THREADS)]
        + [f"{label}:{mod}:{fn}" for label, mod, fn, _, _ in BL_LEGS
           if (label in BL_CPU_SECOND) == bool(i)],
        cwd=ROOT, env=env, stdout=cpu_logs[i], stderr=subprocess.STDOUT)
        for i in range(2)]
    mods = {label: importlib.import_module(f"benchmarks.{mod}")
            for label, mod, _, _, _ in BL_LEGS}
    rows, seconds, launches = {}, {}, {}
    ops.reset_launch_counts()
    try:
        order = ([leg for leg in BL_LEGS if leg[0] not in BL_BARS]
                 + [leg for leg in BL_LEGS if leg[0] in BL_BARS])
        waited = False
        for label, _, fn, _, _ in order:
            if label in BL_BARS and not waited:
                waited = True
                t0 = time.perf_counter()
                for i, cpu in enumerate(cpus):
                    if cpu.wait() != 0:
                        raise AssertionError(
                            "BL: the CPU legs failed:\n"
                            + (out / f"cpu{i}.log").read_text())
                log(f"[BL] waited {time.perf_counter() - t0:.1f} s for the "
                    f"CPU legs; the legs with wall-time bars run alone")
            before = ops.launch_counts()
            t0 = time.perf_counter()
            rows[label] = getattr(mods[label], fn)(quick=True, device="cuda")
            seconds[label] = time.perf_counter() - t0
            launches[label] = {k: v - before[k]
                               for k, v in ops.launch_counts().items()
                               if v - before[k]}
            log(f"[BL] {label}: {len(rows[label])} rows, "
                f"{seconds[label]:.1f} s on the card; launches "
                f"{launches[label]}")
    finally:
        for cpu, cpu_log in zip(cpus, cpu_logs):
            if cpu.poll() is None:
                cpu.kill()
                cpu.wait()
            cpu_log.close()
    for i in range(2):
        log("\n".join(line for line in (out / f"cpu{i}.log").read_text()
                      .splitlines() if line.startswith("[cpu]")))

    for label, _, _, check, view in BL_LEGS:
        mod = mods[label]
        saved = json.loads((out / "cpu" / f"{label}.rows.json").read_text())
        card, host = rows[label], saved["rows"]
        a, b = getattr(mod, view)(card), getattr(mod, view)(host)
        if a != b and not _bl_near_ok(mod, card, host, a, b):
            diff = [(x, y) for x, y in zip(a, b) if x != y][:4]
            raise AssertionError(f"BL {label}: card rows differ from the "
                                 f"CPU rows in count columns: {diff} "
                                 f"({len(a)} vs {len(b)} rows)")
        log(f"[BL] {label}: {len(a)} rows, count columns "
            f"{sorted(a[0]) if a else []} equal on the card and the CPU "
            f"(CPU {saved['seconds']:.1f} s, card {seconds[label]:.1f} s)")
    missed = {}
    for label, _, _, check, _ in BL_LEGS:
        try:
            getattr(mods[label], check)(rows[label])
        except AssertionError as e:
            if label not in BL_BARS:
                raise AssertionError(f"BL {label}: check failed on the "
                                     f"card: {e}") from e
            missed[label] = str(e)
            log(f"[BL] {label}: WALL-TIME BAR MISSED on the card: {e}")
        else:
            log(f"[BL] {label}: check passed on the card")

    # The mesh leg at its full size (the paper's width): 8 and 16 logical
    # shards of 4,000 titles and a (4, 2) mesh of 2,000, under its asserts.
    before = ops.launch_counts()
    t0 = time.perf_counter()
    full = mods["mesh_bench"].run(device="cuda")
    wall = time.perf_counter() - t0
    for row in full:
        log(f"[BL] mesh_bench full: {row['leg']} {row['policy']} "
            f"({row['n_data']}, {row['n_model']}): {row['matches']} matches, "
            f"equal {row['equal']}, gather {row['gather_bytes_per_dev']} B "
            f"/ psum {row['psum_bytes_per_dev']} B per shard"
            + (f", {row['reduction_x']}x below flat" if "reduction_x" in row
               else "") + f", {row['wall_s']} s on one card")
    grew = {k: v - before[k] for k, v in ops.launch_counts().items()
            if v - before[k]}
    log(f"[BL] mesh_bench full size: {len(full)} rows, asserts passed, "
        f"{wall:.1f} s; launches {grew}")

    total = ops.launch_counts()
    for k in ("pair_scores_catalog_compact", "pair_scores_catalog",
              "pair_scores[tma]", "pair_scores[fma]"):
        if total[k] == 0:
            raise AssertionError(f"BL launched no {k}")
    log(f"BL launches {total}; {time.perf_counter() - t_phase:.1f} s")
    log(json.dumps({"bl_bars_missed": missed}))
    return total, missed


# ---------------------------------------------------------------------------
# EX: the torch examples on the card and on the CPU
# ---------------------------------------------------------------------------

EX_ER = ("quickstart", "dedup_sorted_neighborhood", "dedup_two_sources",
         "match_service", "chaos_drill")
EX_DEVICE_KEYS = {"match_service": ("warmup_builds",)}  # not compared
EX_TRAIN_STEPS = 20


def load_example(name):
    """``examples/torch_<name>.py`` as a module (nothing runs on import)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ex_phase(torch, np, kstats):
    """EX: each torch example's ``main`` in-process with ``--device
    cuda``, then ``--device cpu``. The ER examples' returned counts must
    be equal on both (matches, pairs, recall, loads, map output; the
    drill's survivors, rounds, retries, recovered tiles, evictions and
    readmissions; the service's matches per batch); the LM examples'
    tokens must have the asked shape and lie in the vocabulary, and the
    training loss must be finite on both and fall over EX_TRAIN_STEPS
    steps on the card. K1 and K2 (the service's warm-up) must launch;
    the drill's 64 x 64 catalog at width 64, a shape no earlier phase
    holds, is held against the plain versions. Returns the launches of
    the examples' card runs."""
    import shutil
    from repro_torch.kernels import build, ops

    phase("EX the torch examples on the card, held against the CPU")
    t_phase = time.perf_counter()
    mods = {name: load_example(name)
            for name in EX_ER + ("serve_lm", "train_lm")}
    ckpt = build.BUILD_DIR / "ex_ckpt"
    ops.reset_launch_counts()
    card, seconds = {}, {}
    for name in EX_ER:
        t0 = time.perf_counter()
        card[name] = mods[name].main(["--device", "cuda"])
        seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    card["serve_lm"] = mods["serve_lm"].main(["--device", "cuda"])
    seconds["serve_lm"] = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    card["train_lm"] = mods["train_lm"].main(
        ["--steps", str(EX_TRAIN_STEPS), "--ckpt-dir", str(ckpt / "cuda"),
         "--device", "cuda"])
    seconds["train_lm"] = time.perf_counter() - t0
    launches = ops.launch_counts()
    for k in ("pair_scores_catalog_compact", "pair_scores_catalog"):
        if launches[k] == 0:
            raise AssertionError(f"EX launched no {k}")

    for name in EX_ER:
        t0 = time.perf_counter()
        cpu = mods[name].main(["--device", "cpu"])
        skip = EX_DEVICE_KEYS.get(name, ())
        a = {k: v for k, v in card[name].items() if k not in skip}
        b = {k: v for k, v in cpu.items() if k not in skip}
        if a != b:
            diff = {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
                    if a.get(k) != b.get(k)}
            raise AssertionError(f"EX {name}: card counts differ from the "
                                 f"CPU's: {str(diff)[:600]}")
        log(f"[EX] {name}: counts {sorted(a)} equal on the card "
            f"({seconds[name]:.1f} s) and the CPU "
            f"({time.perf_counter() - t0:.1f} s)")
    cpu_serve = mods["serve_lm"].main(["--device", "cpu"])
    for where, got in (("card", card["serve_lm"]), ("cpu", cpu_serve)):
        if got["shape"] != [4, 32] or not (
                0 <= got["min_token"] <= got["max_token"] < got["vocab"]):
            raise AssertionError(f"EX serve_lm on the {where}: {got}")
    log(f"[EX] serve_lm: (4, 32) tokens in [0, {card['serve_lm']['vocab']}) "
        f"on the card ({seconds['serve_lm']:.1f} s) and the CPU")
    cpu_train = mods["train_lm"].main(
        ["--steps", "2", "--ckpt-dir", str(ckpt / "cpu"), "--device", "cpu"])
    tl = card["train_lm"]
    losses = tl["losses"]
    if not (tl["finite"] and cpu_train["finite"] and tl["start"] == 0
            and len(losses) == EX_TRAIN_STEPS
            and np.mean(losses[-5:]) < losses[0]):
        raise AssertionError(f"EX train_lm: losses {losses}, CPU "
                             f"{cpu_train['losses']}")
    log(f"[EX] train_lm: {tl['arch']} ({tl['params']:,} parameters), "
        f"{EX_TRAIN_STEPS} steps on the card ({seconds['train_lm']:.1f} s): "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the last 5 "
        f"{np.mean(losses[-5:]):.4f}), finite; 2 steps on the CPU finite "
        f"({cpu_train['losses']})")
    shutil.rmtree(ckpt, ignore_errors=True)

    catalog, feats = mods["chaos_drill"].workload()
    f = torch.from_numpy(feats).cuda()
    tiles = torch.from_numpy(np.concatenate(
        [catalog.tiles, np.zeros((7, catalog.tiles.shape[1]), np.int32)]
    ).astype(np.int32)).cuda()
    thr = mods["chaos_drill"].THRESH
    compare(torch, f, f, tiles, 64, 64, thr, (64 * 64, 32, 4), kstats,
            "EX chaos drill catalog d=64 (64,64)")
    log(f"[EX] the drill's catalog ({catalog.num_tiles} tiles of 64 x 64, "
        f"width 64, threshold {thr}): both kernels equal to the plain "
        f"versions at capacities 4,096 / 32 / 4")
    log(f"EX launches {launches}; {time.perf_counter() - t_phase:.1f} s")
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
    (1, 8, 8, 512, 96, True, 0.0), (1, 8, 4, 1024, 80, False, -0.125),
    (2, 32, 32, 1024, 80, True, None),  # zamba2-2.7b prefill (LM-f), G = 1
    (1, 32, 8, 32768, 128, True, None))  # qwen3-4b prefill_32k (DR-2)
PLAIN_LOGITS_BYTES = 8 << 30  # the plain attention's f32 logits, per call


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


def _plain_attention(torch, q, k, v, causal, scale):
    """The plain attention route; when all (B, H, S, S) f32 logits would
    pass ``PLAIN_LOGITS_BYTES``, one query head at a time against its kv
    head (q head h reads kv head h // G), concatenated."""
    from repro_torch.kernels import ops

    b, h, s, _ = q.shape
    if b * h * s * s * 4 <= PLAIN_LOGITS_BYTES:
        return ops.attention(q, k, v, causal=causal, scale=scale,
                             impl="torch")
    g = h // k.shape[1]
    return torch.cat([ops.attention(q[:, i:i + 1], k[:, i // g:i // g + 1],
                                    v[:, i // g:i // g + 1], causal=causal,
                                    scale=scale, impl="torch")
                      for i in range(h)], dim=1)


def lm_kernels_phase(torch, np):
    """LM-a: both LM kernels against their plain versions on the card at
    the main path's shapes; returns per-kernel max |kernel - plain| (and
    flash's largest band error, ``ref.band_rel_err``)."""
    from repro_torch.kernels import ops, ref

    phase("LM-a LM kernels vs plain versions (granite, phi-3-vision, "
          "zamba2 and qwen3-4b shapes, head dims 16-128, S to 32,768, "
          "scales <= 0)")
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
            want = _plain_attention(torch, q, k, v, causal, scale)
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
            del q, k, v, got, want
    torch.cuda.empty_cache()

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


def _prefill_and_decode(torch, model, cfg, tokens, steps, device="cuda"):
    """prefill + ``steps`` greedy decode steps through the serving entry
    points; returns (logits per step (B, V) f32, tokens per step)."""
    from repro_torch.models import get_model
    from repro_torch.serve import make_decode_step, make_prefill

    b, s = tokens.shape
    cache = get_model(cfg).init_cache(cfg, b, s + steps + 1, device=device)
    logits, cache = make_prefill(cfg, device=device)(
        model, {"tokens": tokens}, cache)
    out, toks = [logits[:, -1].float()], []
    decode = make_decode_step(cfg, device=device)
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
# T: training (repro_torch.train, repro_torch.launch.train)
# ---------------------------------------------------------------------------

SMOLLM = "smollm-360m"
T_A_RUN = (2, 128, 3)       # batch, seq, steps (tests/test_torch_train_step.py)
T_A_TOL = dict(metrics_rtol=1e-4, aux_atol=1e-6, params_atol=1e-5)
T_B_ARGS = ["--arch", SMOLLM, "--batch", "8", "--seq", "1024",
            "--ckpt-every", "20", "--log-every", "1", "--seed", "0"]
T_B_STEPS = (40, 50)        # the first run, then the resumed one
T_B_PROFILED = 5            # steps profiled one by one for the busy share


def _train_steps(torch, model, cfg, batch, steps):
    """``steps`` train steps (AdamW lr 1e-3) from a fresh optimizer state:
    (metrics per step as floats, the optimizer state)."""
    from repro_torch.train import adamw_init, make_train_step
    from repro_torch.train.optimizer import AdamWConfig

    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    opt = adamw_init(model, AdamWConfig(lr=1e-3))
    out = []
    for _ in range(steps):
        model, opt, m = step(model, opt, batch)
        out.append({k: float(v) for k, v in m.items()})
    return out, opt


def train_check_phase(torch, np):
    """T-a: three train steps on the card against the same three on the
    CPU from the same weights, f32 with TF32 off: smollm-360m and
    granite-moe-1b-a400m (gshard, so the router aux loss's gradient runs)
    at full width, 2 layers, ``remat`` on (the full configs')."""
    from repro_torch.models import get_model

    phase("T-a train steps on the card vs the CPU: smollm-360m and "
          "granite-moe-1b-a400m (gshard) at full width, 2 layers, float32")
    b, s, steps = T_A_RUN
    worst = {}
    for arch in (SMOLLM, GRANITE):
        cfg, card = granite(torch, arch, n_layers=2, param_dtype="float32",
                            compute_dtype="float32")
        cpu = get_model(cfg).empty(cfg, device="cpu")
        cpu.load_state_dict(card.state_dict())
        rng = np.random.default_rng(5)
        batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)),
                 "labels": rng.integers(0, cfg.vocab, (b, s))}
        batch["labels"][0, :5] = -100
        t0 = time.perf_counter()
        got, _ = _train_steps(torch, card, cfg, batch, steps)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want, _ = _train_steps(torch, cpu, cfg, batch, steps)
        cpu_s = time.perf_counter() - t0
        rel = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got, want)
                  for k in ("loss", "xent", "grad_norm", "lr"))
        aux = max(abs(g["aux"] - w["aux"]) for g, w in zip(got, want))
        pdiff = max((a.cpu() - c).abs().max().item() for a, c in zip(
            card.parameters(), cpu.parameters()))
        log(f"{arch}: {steps} steps of B={b} x S={s}: losses card "
            f"{[g['loss'] for g in got]} / CPU {[w['loss'] for w in want]}; "
            f"aux {[g['aux'] for g in got]}; grad_norm "
            f"{[g['grad_norm'] for g in got]}; max rel diff of loss / xent /"
            f" grad_norm / lr {rel:.3e} (rtol {T_A_TOL['metrics_rtol']}), "
            f"max |aux diff| {aux:.3e} (atol {T_A_TOL['aux_atol']}), max "
            f"|param diff| {pdiff:.3e} (atol {T_A_TOL['params_atol']}); "
            f"card {card_s:.2f} s, CPU {cpu_s:.2f} s")
        if not (rel <= T_A_TOL["metrics_rtol"] and aux <= T_A_TOL["aux_atol"]
                and pdiff <= T_A_TOL["params_atol"]):
            raise AssertionError(f"T-a {arch}: the card's train steps differ "
                                 "from the CPU's")
        if cfg.family == "moe" and not got[0]["aux"] > 0:
            raise AssertionError("T-a: the MoE aux loss is 0")
        worst[arch] = dict(metrics_rel=rel, aux_abs=aux, params_abs=pdiff)
        del card, cpu
    torch.cuda.empty_cache()
    return worst


def train_slice_phase(torch, np):
    """T-b: smollm-360m at full width and depth, bf16, ``remat``, random
    weights from seed 0, through the launcher (``launch.train``): 40 steps of
    8 x 1,024 tokens with async checkpoints every 20 into a temp dir, then
    ``main`` again to 50, which must resume from step 40; the checkpoint
    of step 40 must equal the first run's params and moments bit for bit.
    Step ms, tokens/s, peak memory, and the device busy share (median of
    ``T_B_PROFILED`` profiled steps)."""
    import io
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    from repro_torch.train import make_train_step
    from repro_torch.train.checkpoint import latest_step, restore
    from repro_torch.train.optimizer import AdamWConfig

    phase("T-b the slice: launch.train, smollm-360m full width and depth, "
          "bf16, remat, 40 steps of 8 x 1024, checkpoints every 20, then "
          "resume to 50")
    first, second = T_B_STEPS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as ckpt:
        argv = T_B_ARGS + ["--ckpt-dir", ckpt]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = launch.train(launch.parse_args(argv + ["--steps", str(first)]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        cfg, model, losses = res["cfg"], res["model"], res["losses"]
        n_params = sum(p.numel() for p in model.parameters())
        if cfg != get_config(SMOLLM) or not cfg.remat \
                or cfg.compute_dtype != "bfloat16":
            raise AssertionError(f"T-b runs {cfg}, not the full config")
        if len(losses) != first or not all(np.isfinite(losses)):
            raise AssertionError(f"T-b losses: {losses}")
        if not np.mean(losses[-5:]) < losses[0]:
            raise AssertionError(f"T-b: the loss did not fall: {losses}")
        steady = [dt for i, dt in res["step_s"] if i > 5]
        step_ms = float(np.median(steady)) * 1e3
        tok_s = res["tokens_per_step"] / (step_ms * 1e-3)
        flops = 6.0 * n_params * res["tokens_per_step"]
        log(f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} / "
            f"{cfg.n_kv_heads} heads, vocab {cfg.vocab}: {n_params:,} "
            f"parameters; {first} steps in {wall:.2f} s (model init and "
            f"data included); losses {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"(mean of the last 5 {np.mean(losses[-5:]):.4f}); median step "
            f"after step 5: {step_ms:.2f} ms = {tok_s:,.0f} tokens/s "
            f"({flops / 1e12:.1f} TFLOP a step at 6·N·tokens -> "
            f"{flops / (step_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
            f"{flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS:.1%} of the bf16 "
            f"peak); peak memory {peak / 2**30:.2f} GiB")
        if latest_step(ckpt) != first:
            raise AssertionError(f"T-b: latest checkpoint "
                                 f"{latest_step(ckpt)}, not {first}")
        state, _ = restore(ckpt, step=first, device="cuda")
        for name, p in model.named_parameters():
            if not torch.equal(state["params"][name], p):
                raise AssertionError(f"T-b: checkpointed {name} differs")
        for key in ("m", "v"):
            for name, t in res["opt_state"][key].items():
                if not torch.equal(state["opt"][key][name], t):
                    raise AssertionError(f"T-b: checkpointed {key}.{name} "
                                         "differs")
        log(f"checkpoint of step {first}: every parameter and both "
            f"moments equal the run's in memory bit for bit "
            f"({len(state['params'])} parameters)")
        del state
        # the device busy share of T_B_PROFILED steps, each under its own
        # torch.profiler, on the in-memory state after the run
        step = make_train_step(cfg, AdamWConfig(lr=3e-3), total_steps=first)
        batch = {"tokens": torch.randint(0, cfg.vocab, (8, 1024),
                                         device="cuda"),
                 "labels": torch.randint(0, cfg.vocab, (8, 1024),
                                         device="cuda")}
        opt = res["opt_state"]
        step(model, opt, batch)
        shares = []
        for _ in range(T_B_PROFILED):
            pwall, cats = device_breakdown(
                torch, lambda: step(model, opt, batch), kernels=())
            busy = cats["other"]
            if busy == 0:
                break
            shares.append(busy / pwall)
            top = sorted(cats["other_by_name"].items(),
                         key=lambda kv: -kv[1])[:6]
            log(f"one train step under torch.profiler: wall "
                f"{pwall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms "
                f"({busy / pwall:.1%}); {cats['device_events']} kernels and "
                "copies; largest (ms): " + "; ".join(
                    f"{n} {sec * 1e3:.2f}" for n, sec in top))
        busy_share = float(np.median(shares)) if shares else None
        if shares:
            log(f"busy share over {len(shares)} profiled steps: median "
                f"{busy_share:.1%}, min {min(shares):.1%}, max "
                f"{max(shares):.1%}")
        else:
            log("train step under torch.profiler: the profiler saw no "
                "device time (busy share not measured)")
        del model, opt, res
        torch.cuda.empty_cache()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = launch.main(argv + ["--steps", str(second)])
        resume_s = time.perf_counter() - t0
        text = out.getvalue()
        log("  " + "\n  ".join(text.strip().splitlines()[:3] + ["..."]
                               + text.strip().splitlines()[-2:]))
        if rc != 0 or f"resumed from step {first}" not in text \
                or f"step {second:5d}  loss" not in text \
                or latest_step(ckpt) != second:
            raise AssertionError(f"T-b: main did not resume from step "
                                 f"{first} to {second} (rc {rc})")
        log(f"main(--steps {second}): rc 0, resumed from step {first}, "
            f"{second - first} more steps in {resume_s:.2f} s")
    return dict(step_ms=step_ms, tokens_per_s=tok_s, peak_bytes=peak,
                loss_first=losses[0], loss_last5=float(np.mean(losses[-5:])),
                busy_share=busy_share)


# ---------------------------------------------------------------------------
# LM-f: the ssm / hybrid / audio families
# ---------------------------------------------------------------------------

ZAMBA2 = "zamba2-2.7b"
RWKV6 = "rwkv6-7b"
WHISPER = "whisper-base"
LM_F_RUNS = {ZAMBA2: (2, 1024, 8), RWKV6: (2, 512, 8), WHISPER: (2, 64, 8)}


def _serve_round(torch, cfg, model, batch, new, label):
    """generate (cold, launches counted), prefill alone then ``new`` - 1
    greedy decode steps on its cache (each timed), generate again (the
    same tokens): the serving numbers of one configuration."""
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.serve import generate, make_decode_step, make_prefill

    b, s = batch["tokens"].shape
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
        raise AssertionError(f"{label}: generate returned "
                             f"{tuple(out.shape)} or ids outside the vocab")
    cache = get_model(cfg).init_cache(cfg, b, s + new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = make_prefill(cfg)(model, batch, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: non-finite prefill logits")
    decode = make_decode_step(cfg)
    tok = logits[:, -1].argmax(-1)[:, None]
    t0 = time.perf_counter()
    for _ in range(new - 1):
        step_logits, cache = decode(model, tok, cache)
        tok = step_logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / max(new - 1, 1) * 1e3
    t0 = time.perf_counter()
    again = generate(model, cfg, batch, new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if not torch.equal(out, again):
        raise AssertionError(f"{label}: two greedy runs gave different "
                             "tokens")
    log(f"{label} B={b} x {s} tokens, {new} new: launches "
        f"{ {k: v for k, v in launches.items() if v} }; first generate "
        f"{first_s:.3f} s (cold); prefill {prefill_s:.3f} s; decode "
        f"{decode_ms:.2f} ms/token-step; generate {gen_s:.3f} s "
        f"({b * new / gen_s:.1f} tokens/s, {b * s / prefill_s:,.0f} prompt "
        f"tokens/s in prefill); peak memory {peak / 2**30:.2f} GiB; "
        f"tokens[0] {out[0].tolist()}; repeat run equal")
    return logits, dict(b=b, s=s, new=new, prefill_s=prefill_s,
                        generate_s=gen_s, decode_ms=decode_ms,
                        tokens_per_s=b * new / gen_s, peak_bytes=peak,
                        launches=launches)


def _params_line(cfg, model):
    n = sum(p.numel() for p in model.parameters())
    return (f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"vocab {cfg.vocab}: {n:,} parameters ({n * 2 / 1e9:.2f} GB "
            "bf16)")


def lm_families_phase(torch, np):
    """LM-f: zamba2-2.7b on the flash route (12 layers f32 against the
    plain route, then full depth bf16 through ``generate``), rwkv6-7b (2
    layers f32 on the card against the CPU, then full bf16) and
    whisper-base (plain route, full bf16; the kernel route raises). Returns
    (the flash launches of the zamba2 ``generate``, the rows)."""
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.serve import generate, make_prefill

    phase("LM-f the ssm / hybrid / audio families: zamba2-2.7b (flash "
          "route, head dim 80), rwkv6-7b, whisper-base; random weights, "
          "seed 0")
    rows = {}
    rng = np.random.default_rng(7)

    # zamba2, 12 layers (two super-blocks), f32: kernel route vs plain
    kern, model = granite(torch, ZAMBA2, n_layers=12, param_dtype="float32",
                          compute_dtype="float32", attn_impl="kernel")
    plain = kern.replace(attn_impl="plain", kernel_impl="torch")
    tokens = torch.from_numpy(rng.integers(0, kern.vocab, (2, 256))).cuda()
    ops.reset_launch_counts()
    lk, tk = _prefill_and_decode(torch, model, kern, tokens, 4)
    counts = ops.launch_counts()
    lp, tpl = _prefill_and_decode(torch, model, plain, tokens, 4)
    worst = max((a - b).abs().max().item() for a, b in zip(lk, lp))
    n_sup = kern.n_layers // kern.shared_attn_every
    if counts["flash_attention"] != n_sup or not all(
            torch.allclose(a, b, **LM_B_TOL) for a, b in zip(lk, lp)) \
            or not all(torch.equal(a, b) for a, b in zip(tk, tpl)):
        raise AssertionError(f"LM-f zamba2 12 layers f32: flash launches "
                             f"{counts['flash_attention']} (want {n_sup}), "
                             f"max |logit diff| {worst}")
    log(f"zamba2 12 layers f32, B=2 S=256: kernel route (flash launches "
        f"{counts['flash_attention']}, one per super-block) vs plain route: "
        f"prefill + 4 decode steps max |logit diff| {worst:.3e} within atol "
        f"{LM_B_TOL['atol']} / rtol {LM_B_TOL['rtol']}; greedy tokens equal "
        f"{[t.tolist() for t in tk]}")
    rows["zamba2_f32_max_diff"] = worst
    del model
    torch.cuda.empty_cache()

    cfg, model = granite(torch, ZAMBA2, attn_impl="kernel")
    log(_params_line(cfg, model) + f"; {cfg.n_heads} heads of {cfg.hd}, "
        f"shared block every {cfg.shared_attn_every}")
    b, s, new = LM_F_RUNS[ZAMBA2]
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s))).cuda()}
    logits, rows[ZAMBA2] = _serve_round(torch, cfg, model, batch, new,
                                        "zamba2-2.7b")
    launches = rows[ZAMBA2]["launches"]["flash_attention"]
    if launches != cfg.n_layers // cfg.shared_attn_every:
        raise AssertionError(f"zamba2 generate: {launches} flash launches, "
                             "not one per super-block")
    plain = cfg.replace(attn_impl="plain", kernel_impl="torch")
    ref_logits, _ = make_prefill(plain)(
        model, batch, get_model(plain).init_cache(plain, b, s + 1))
    diff = (logits.float() - ref_logits.float()).abs().max().item()
    agree = (logits.float().argmax(-1) == ref_logits.float().argmax(-1)
             ).float().mean().item()
    log(f"zamba2 full depth, bf16: kernel vs plain-route prefill logits max "
        f"|diff| {diff:.3e} (informative; logit scale "
        f"{ref_logits.float().abs().max().item():.2f}); next-token argmax "
        f"agrees on {agree:.0%} of the prompts")
    rows[ZAMBA2]["plain_logit_diff"] = diff
    del model
    torch.cuda.empty_cache()

    # rwkv6, 2 layers f32 at full width: the card against the CPU
    cfg2, card = granite(torch, RWKV6, n_layers=2, param_dtype="float32",
                         compute_dtype="float32")
    cpu = get_model(cfg2).empty(cfg2, device="cpu")
    cpu.load_state_dict(card.state_dict())
    tokens = torch.from_numpy(rng.integers(0, cfg2.vocab, (2, 64)))
    lc, tc = _prefill_and_decode(torch, card, cfg2, tokens.cuda(), 4)
    lh, th = _prefill_and_decode(torch, cpu, cfg2, tokens, 4, device="cpu")
    worst = max((a.cpu() - b).abs().max().item() for a, b in zip(lc, lh))
    if not all(torch.allclose(a.cpu(), b, **LM_B_TOL) for a, b in zip(lc, lh)) \
            or not all(torch.equal(a.cpu(), b) for a, b in zip(tc, th)):
        raise AssertionError(f"LM-f rwkv6 2 layers f32: card and CPU differ "
                             f"by {worst}")
    log(f"rwkv6 2 layers f32 full width, B=2 S=64: card vs CPU prefill + 4 "
        f"decode steps max |logit diff| {worst:.3e} within atol "
        f"{LM_B_TOL['atol']} / rtol {LM_B_TOL['rtol']}; greedy tokens equal")
    rows["rwkv6_f32_max_diff"] = worst
    del card, cpu
    torch.cuda.empty_cache()

    cfg, model = granite(torch, RWKV6)
    log(_params_line(cfg, model) + f"; {cfg.n_heads} WKV heads of {cfg.hd}")
    b, s, new = LM_F_RUNS[RWKV6]
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s))).cuda()}
    _, rows[RWKV6] = _serve_round(torch, cfg, model, batch, new, "rwkv6-7b")
    del model
    torch.cuda.empty_cache()

    cfg, model = granite(torch, WHISPER)
    log(_params_line(cfg, model) + f" + {cfg.n_encoder_layers} encoder "
        f"layers; {cfg.n_audio_frames} stub frames")
    b, s, new = LM_F_RUNS[WHISPER]
    batch = {"tokens": torch.from_numpy(
                 rng.integers(0, cfg.vocab, (b, s))).cuda(),
             "frames": torch.from_numpy(rng.standard_normal(
                 (b, cfg.n_audio_frames, cfg.d_model)).astype(
                     np.float32)).cuda()}
    _, rows[WHISPER] = _serve_round(torch, cfg, model, batch, new,
                                    "whisper-base (plain route)")
    try:
        generate(model, cfg.replace(attn_impl="kernel"), batch, 2)
    except ValueError as e:
        log(f"whisper on the kernel route raises ValueError: {e}")
    else:
        raise AssertionError("whisper on the kernel route did not raise")
    del model
    torch.cuda.empty_cache()
    return launches, rows


# ---------------------------------------------------------------------------
# DR: the cell harness's cells at full width and depth, measured against
# the dry-run's prediction
# ---------------------------------------------------------------------------

DR_CELLS = (  # (label, arch, shape, the global batch one card holds)
    ("DR-1", SMOLLM, "train_4k", 2),
    ("DR-2", "qwen3-4b", "prefill_32k", 1),
    ("DR-3", GRANITE, "decode_32k", 8),
)
DR_STEPS = {"train": (1, 3), "prefill": (0, 1), "decode": (1, 10)}
# measured peak / predicted peak live + argument bytes: both sides count
# the same tensors, so the card's allocator may add only a few per cent
DR_MEMORY_RATIO = (0.95, 1.05)
DR_KERNEL_STEPS = {"prefill": (1, 3), "decode": (1, 10)}


def _dr_time(torch, fn, args, warm, steps):
    """``warm`` untimed then ``steps`` timed calls of ``fn(*args)`` (host
    clock, each ending in ``torch.cuda.synchronize()``); returns (mean
    seconds a step, the last output)."""
    out = None
    for _ in range(warm):
        out = fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        out = fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps, out


def _next_tokens(logits):
    return logits[:, -1].float().argmax(-1)


def dr_phase(torch, np, smi):
    """DR: ``steps.build_cell(device="cuda")`` on the one-card test mesh at
    full width and depth, bf16, random weights from seed 0, the global
    batch cut to one card's share: DR-1 smollm-360m × train_4k, DR-2
    qwen3-4b × prefill_32k (plain route, then the flash kernel route; the
    same next token), DR-3 granite-moe × decode_32k at pos 32,767 (plain /
    gshard, then grouped + kernel routes, timed in bf16; the same next
    tokens and logits in f32, :func:`_dr_moe_f32`). Each
    cell's measured step, peak memory and MFU beside ``dryrun.run_cell``'s
    prediction for the same cut cell on the same mesh. Returns (the kernel
    launches of the phase, the rows)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.launch.steps import build_cell, make_step, scan_trips

    phase("DR the cell harness at full width and depth: measured vs the "
          "dry-run's prediction (H100 data-sheet constants)")
    t_phase = time.perf_counter()
    mesh = make_test_mesh(1)
    log(f"mesh: {mesh.shape} on {mesh.first_device}; {smi}")
    launches, rows = {}, {}
    for label, arch, shape_name, batch in DR_CELLS:
        cfg, full = get_config(arch), SHAPES[shape_name]
        shape = dataclasses.replace(full, global_batch=batch)
        kind = shape.kind
        log(f"{label} {arch} x {shape_name}: global batch "
            f"{full.global_batch} -> {batch} ({batch} x {shape.seq_len:,} "
            f"{'context' if kind == 'decode' else 'tokens'}), "
            f"{scan_trips(cfg)} trips of depth")
        pred = run_cell(cfg, shape, mesh, "1x1")
        torch.cuda.empty_cache()
        cell = build_cell(cfg, shape, mesh, layer_unroll=scan_trips(cfg),
                          device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        warm, steps = DR_STEPS[kind]
        step_s, out = _dr_time(torch, cell.fn, cell.args, warm, steps)
        peak = torch.cuda.max_memory_allocated()
        if kind == "train":
            loss = float(out[2]["loss"])
            if not np.isfinite(loss):
                raise AssertionError(f"{label}: loss {loss}")
            check = f"loss {loss:.4f} finite"
        else:
            logits = out[0]
            if tuple(logits.shape) != (batch, 1, cfg.vocab) \
                    or not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{label}: logits {tuple(logits.shape)}"
                                     " not finite or misshapen")
            check = f"logits {tuple(logits.shape)} finite"
        mfu = model_flops(cfg, shape) / (PEAK_FLOPS * step_s)
        pred_mem = pred["temp_bytes/dev"] + pred["arg_bytes/dev"]
        row = dict(step_s=step_s, peak_bytes=peak, mfu=mfu,
                   pred_step_s=pred["step_s"],
                   pred_bottleneck=pred["bottleneck"],
                   pred_compute_s=pred["compute_s"],
                   pred_memory_s=pred["memory_s"],
                   pred_collective_s=pred["collective_s"],
                   pred_bytes=pred_mem, pred_mfu=pred["mfu"],
                   step_ratio=step_s / pred["step_s"],
                   memory_ratio=peak / pred_mem)
        log(f"{label} measured: step {step_s:.4f} s (mean of {steps} after "
            f"{warm} warm-up), peak memory {peak / 2**30:.2f} GiB, MFU "
            f"{mfu:.4f}; {check}")
        log(f"{label} predicted: step {pred['step_s']:.4f} s "
            f"({pred['bottleneck']}; compute {pred['compute_s']:.4f} / "
            f"memory {pred['memory_s']:.4f} / collective "
            f"{pred['collective_s']:.4f} s), peak live + arguments "
            f"{pred_mem / 2**30:.2f} GiB, MFU {pred['mfu']:.4f}; measured / "
            f"predicted: step {row['step_ratio']:.3f}, memory "
            f"{row['memory_ratio']:.3f} (limits {DR_MEMORY_RATIO})  [{smi}]")
        lo, hi = DR_MEMORY_RATIO
        if not lo <= row["memory_ratio"] <= hi:
            raise AssertionError(f"{label}: measured / predicted memory "
                                 f"{row['memory_ratio']:.3f} outside "
                                 f"{DR_MEMORY_RATIO}")
        if kind in DR_KERNEL_STEPS:
            fast = cfg.replace(attn_impl="kernel") if kind == "prefill" \
                else cfg.replace(attn_impl="kernel", moe_dispatch="grouped")
            dev = torch.device("cuda")
            before = ops.launch_counts()
            warm, steps = DR_KERNEL_STEPS[kind]
            torch.cuda.reset_peak_memory_stats()
            k_s, k_out = _dr_time(torch, make_step(fast, kind, dev,
                                                   shape.seq_len - 1),
                                  cell.args, warm, steps)
            k_peak = torch.cuda.max_memory_allocated()
            after = ops.launch_counts()
            used = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
            for k, n in used.items():
                launches[k] = launches.get(k, 0) + n
            got, want = _next_tokens(k_out[0]), _next_tokens(out[0])
            agree = int((got == want).sum())
            top2 = out[0][:, -1].float().topk(2, dim=-1).values
            gap = float((top2[:, 0] - top2[:, 1]).min())
            diff = float((k_out[0].float() - out[0].float()).abs().max())
            row.update(kernel_step_s=k_s, kernel_peak_bytes=k_peak,
                       kernel_mfu=model_flops(cfg, shape) / (PEAK_FLOPS
                                                             * k_s),
                       kernel_launches=used, logit_diff=diff,
                       tokens_agree=agree)
            log(f"{label} {'flash' if kind == 'prefill' else 'grouped'} "
                f"route: step {k_s:.4f} s (mean of {steps} after {warm} "
                f"warm-up; {step_s / k_s:.2f}x the plain route), peak memory "
                f"{k_peak / 2**30:.2f} GiB, MFU {row['kernel_mfu']:.4f}, "
                f"launches {used}; next tokens {got.tolist()}, the plain "
                f"route's {want.tolist()} ({agree}/{batch} equal; max |logit "
                f"diff| {diff:.3e}, least top-2 gap of the plain route "
                f"{gap:.3e})")
            if kind == "prefill" and not torch.equal(got, want):
                raise AssertionError(f"{label}: the kernel route's next "
                                     f"token {got.tolist()} != the plain "
                                     f"route's {want.tolist()}")
            del k_out
        rows[label] = row
        del cell, out
        torch.cuda.empty_cache()
        if cfg.family == "moe":
            row["f32_max_diff"] = _dr_moe_f32(torch, cfg, shape, mesh, label)
    for name in ("flash_attention", "grouped_matmul"):
        if not launches.get(name):
            raise AssertionError(f"DR: {name} never launched")
    log(f"DR launches: {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, rows


def _dr_moe_f32(torch, cfg, shape, mesh, label):
    """The MoE cell's routes held against each other in f32, TF32 off, on
    the same weights (seed 0: the f32 values the bf16 cell rounds), context
    and tokens: the grouped + kernel route against the plain gshard route
    at the capacity factor E / k, where capacity is the group's tokens and
    no slot can drop (an expert takes at most one slot per token; at the
    config's factor gshard drops slots, the grouped route none). In bf16,
    24 layers of top-k routing turn rounding into other experts, so the
    bf16 routes' tokens are compared above but not required equal. Returns
    the max |logit diff|."""
    from repro_torch.launch.steps import build_cell, make_step, scan_trips

    f32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    cell = build_cell(f32, shape, mesh, layer_unroll=scan_trips(f32),
                      device="cuda")
    dev, pos = torch.device("cuda"), shape.seq_len - 1
    free = f32.replace(capacity_factor=f32.num_experts / f32.top_k)
    want = make_step(free, "decode", dev, pos)(*cell.args)[0]
    got = make_step(f32.replace(attn_impl="kernel", moe_dispatch="grouped"),
                    "decode", dev, pos)(*cell.args)[0]
    diff = float((got - want).abs().max())
    if not torch.equal(_next_tokens(got), _next_tokens(want)) \
            or not torch.allclose(got, want, **LM_B_TOL):
        raise AssertionError(f"{label} f32: grouped + kernel route "
                             f"{_next_tokens(got).tolist()} vs drop-free "
                             f"gshard {_next_tokens(want).tolist()}, max "
                             f"|logit diff| {diff}")
    log(f"{label} f32, full width and depth, same weights / context / "
        f"tokens: grouped + kernel route = plain gshard route at capacity "
        f"factor {free.capacity_factor} (drop-free): next tokens "
        f"{_next_tokens(got).tolist()} equal, max |logit diff| "
        f"{diff:.3e} within atol {LM_B_TOL['atol']} / rtol "
        f"{LM_B_TOL['rtol']}")
    del cell, got, want
    torch.cuda.empty_cache()
    return diff


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
    er_s_launches, er_s = er_service_phase(torch, np, ds)
    er_m_launches = er_mesh_phase(torch, np, ds, ds1_rows, er_s)
    del ds, ds1_rows, er_s
    bl_launches, bl_missed = bl_phase(torch, np)
    ex_launches = ex_phase(torch, np, kstats)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for f32 matmuls; the f32 plain "
                             "versions and LM-b assume it off")
    lm_errs, lm_cases = lm_kernels_phase(torch, np)
    lm_wiring_phase(torch, np)
    cfg, model, lm_launches, _ = lm_slice_phase(torch, np)
    vlm_launches, vlm_row = lm_vlm_phase(torch, np)
    lm_times = lm_timing_phase(torch, np, cfg, model, yardstick_lib)
    del model
    torch.cuda.empty_cache()
    train_check_phase(torch, np)
    train_slice_phase(torch, np)
    lm_f_launches, _ = lm_families_phase(torch, np)
    dr_launches, _ = dr_phase(torch, np, smi)

    phase("7 summary")
    from repro_torch.kernels.ref import ATTENTION_BAND_TOL, GROUPED_BAND_TOL

    summary = []
    for kname, line, launches, path in (
            ("pair_scores_catalog_compact", 409,
             main_launches["pair_scores_catalog_compact"],
             "DS1 pair_range run_er, default capacity; bl_launches: phase "
             "BL, the torch legs of benchmarks/ at --quick and "
             "torch_mesh_bench at full size; ex_launches: phase EX, the "
             "torch examples on the card"),
            ("pair_scores_catalog", 301,
             overflow_launches["pair_scores_catalog"],
             "DS1 pair_range run_er, compact_capacity=16 (overflow path); "
             "bl_launches: phase BL (the services' warm-up); ex_launches: "
             "phase EX (torch_match_service's and torch_chaos_drill's "
             "warm-up)")):
        summary.append(dict(
            name=kname, route="cuda",
            source="src/repro_torch/csrc/pair_sim.cu",
            replaces=f"src/repro/kernels/pair_sim.py:{line}",
            launches=launches, path=path,
            er_s_launches=er_s_launches[kname],
            er_m_launches=er_m_launches[kname],
            bl_launches=bl_launches[kname],
            ex_launches=ex_launches[kname],
            max_abs_err=kstats[kname]["max_abs_err"],
            near_threshold_flips=kstats[kname]["near_flips"],
            compared_cases=kstats[kname]["cases"],
            tolerance=f"exact except cells whose f64 score is within "
                      f"{NEAR} of the threshold",
            **times[kname]))
    summary.append(dict(
        name="pair_scores", route="cuda",
        source="src/repro_torch/csrc/pair_sim.cu",
        bf16_source="src/repro_torch/csrc/dense_scores.cu",
        replaces="src/repro/kernels/pair_sim.py:164",
        launches=dense_launches["all"],
        launches_tma=dense_launches["tma"],
        launches_fma=dense_launches["fma"],
        bl_launches=bl_launches["pair_scores"],
        bl_launches_tma=bl_launches["pair_scores[tma]"],
        bl_launches_fma=bl_launches["pair_scores[fma]"],
        path="ops.pair_scores (phase D: the test sweep, kernel_bench's "
             "shapes and the first 16,384 DS1 titles, f32 and bf16; "
             "bl_launches: phase BL, torch_kernel_bench); times "
             "on the DS1 case, triangular, 128x128, f32 (bf16_* in bf16; "
             "bf16_earlier_ms: the FMA kernel in turns in this run; "
             "bf16_fill_ms: fill_ of the same output; bf16_two_copies_ms: "
             "b a second copy of a)",
        max_abs_err=dstats["max_abs_err"],
        tma_max_abs_err=dstats["tma_max_abs_err"],
        near_threshold_flips=dstats["near_flips"],
        compared_cases=dstats["cases"],
        tolerance=f"{DENSE_TOL['float32']} on the bf16 wgmma + TMA route "
                  f"and f32, {DENSE_TOL['bfloat16']} bf16 on the FMA route, "
                  f"on cells both sides keep or drop; a cell kept by one "
                  f"side only must score within {NEAR} of the threshold",
        **{k: v for k, v in dense_times["float32"].items() if k != "route"},
        **{f"bf16_{k}": v for k, v in dense_times["bfloat16"].items()}))
    flash = lm_times["flash_attention"]
    phi3 = lm_times["flash_attention[phi-3-vision]"]
    summary.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:125",
        launches=lm_launches["flash_attention"],
        launches_phi3=vlm_launches["flash_attention"],
        launches_zamba2=lm_f_launches,
        launches_dr=dr_launches["flash_attention"],
        path="LM-c generate, granite-moe prefill (attn_impl=kernel); "
             "launches_phi3: LM-e generate, phi-3-vision prefill (head dim "
             "96); launches_zamba2: LM-f generate, zamba2-2.7b prefill "
             "(head dim 80, one per super-block); launches_dr: DR-2, "
             "qwen3-4b x prefill_32k on the kernel route (S 32,768, D 128); "
             "times at granite's prefill shape, phi3_* at phi-3-vision's",
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
        launches_dr=dr_launches["grouped_matmul"],
        path="LM-c generate, granite-moe MoE FFN (moe_dispatch=grouped); "
             "launches_dr: DR-3, granite-moe x decode_32k on the grouped "
             "route (block_t 8); "
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
    log(f"BL wall-time bars missed on this card: {bl_missed or 'none'}")
    log(smi)
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

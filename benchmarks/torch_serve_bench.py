"""Serving throughput on the port: queries/sec vs batch size on the
resident index, sequential ``match`` vs the super-batching front-end
(torch leg of ``serve_bench``).

The corpus follows the Fig. 9 robustness setup at s = 1.0 (block sizes
|Φ_k| ∝ e^{−s·k} over b blocks, as distinct 3-char prefixes, so the
service's prefix blocking recovers that skew); queries are perturbed
corpus samples plus a few null-key entries. Each batch size runs two
legs over the same micro-batches after one warmup: **sequential** (one
``ERService.match`` per micro-batch) and **batched** (the same
micro-batches submitted at once through :class:`ERBatcher`). Stage 1
runs K1 on the card.

The batcher's coalescing window is the JAX leg's 10 ms (``max_delay_s``).
The super-batched leg takes at least that window plus one super-batch,
so over 6 micro-batches of 8 that each take T8 sequentially, the speedup
is at most 6·T8 / (10 ms + T8): below the bar wherever T8 < 10 ms.

Asserted in :func:`measure` (exact): batched responses equal the
sequential match sets; no kernel build or load in steady state (the
port's ``compile_counter``); no host survivor scan (stage 1 decodes only
the compact epilogue). Asserted in :func:`check` (the wall-time bar):
super-batching gives >= 3x sequential queries/s at micro-batch 8.

    PYTHONPATH=src python -m benchmarks.torch_serve_bench [--quick] [--device cpu|cuda]
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.er import ERBatcher, ERService, ServiceConfig, compile_counter
from repro_torch.er.blocking import exponential_block_sizes
from repro_torch.er.compiler import stage1_stats
from repro_torch.er.datasets import _WORDS, _perturb, _prefixes

from .common import print_table, save_rows, timer
from .torch_common import cli, count_view, impl_of

BATCHING_BAR = 3.0     # batched / sequential queries/s at the smallest size
MAX_DELAY_S = 0.01     # the JAX leg's coalescing window (max_delay_s)
# The columns that equal the JAX leg's row for row (the rest are clocks).
COUNTS = ("batch_size", "batches", "planned_pairs_per_q", "matches",
          "steady_compiles", "host_nonzero")


def skewed_corpus(n: int, b: int, s: float, seed: int = 0):
    """Titles whose 3-char-prefix blocks realize the Fig. 9 exponential
    skew |Φ_k| ∝ e^{−s·k}."""
    rng = np.random.default_rng(seed)
    sizes = exponential_block_sizes(n, b, s)
    prefixes, _ = _prefixes(b)
    titles = []
    for blk, size in enumerate(sizes):
        w = rng.integers(0, len(_WORDS), (size, 2))
        serial = rng.integers(0, 10_000, size)
        titles.extend(
            f"{prefixes[blk]} {_WORDS[a]} {_WORDS[c]} {v:04d}"
            for a, c, v in zip(w[:, 0], w[:, 1], serial))
    rng.shuffle(titles)
    return titles, rng


def _pct(lat, q) -> float:
    return round(1e3 * float(np.percentile(np.asarray(lat), q)), 2)


def measure(n: int = 20_000, b: int = 100, batches_per_size: int = 20,
            quick: bool = False, device="cuda"):
    dev = resolve_device(device)
    if quick:
        n, batches_per_size = 4_000, 6
    titles, rng = skewed_corpus(n, b, s=1.0)
    cfg = ServiceConfig(feature_dim=128, max_len=48, r=32, m=8,
                        query_buckets=(8, 32, 128, 512), tile_chunk=256,
                        kernel_impl=impl_of(dev))

    with timer() as t_ingest:
        svc = ERService(titles, cfg, device=dev)
    with compile_counter() as warm, timer() as t_warm:
        svc.warmup()

    def make_batch(size: int):
        out = []
        for _ in range(size):
            src = titles[int(rng.integers(0, len(titles)))]
            out.append("" if rng.random() < 0.02 else _perturb(rng, src))
        return out

    rows = []
    for size in cfg.query_buckets:
        micro = [make_batch(size) for _ in range(batches_per_size)]
        nq = batches_per_size * size
        pre = dict(svc.stats)
        nz0 = stage1_stats["nonzero_decodes"]

        # ---- sequential leg: one match() per micro-batch ----
        seq_lat, seq_resp = [], []
        with compile_counter() as steady, timer() as t_seq:
            for q in micro:
                with timer() as tq:
                    seq_resp.append(set(svc.match(q)))
                seq_lat.append(tq.seconds)
        planned = svc.stats["planned_pairs"] - pre["planned_pairs"]

        # ---- batched leg: SAME micro-batches, submitted concurrently,
        # coalesced into bucket-shaped super-batches ----
        bat_lat = {}
        submit_at = {}
        with compile_counter() as bsteady, timer() as t_bat:
            with ERBatcher(svc, max_delay_s=MAX_DELAY_S) as batcher:
                futs = []
                for i, q in enumerate(micro):
                    submit_at[i] = time.perf_counter()
                    fut = batcher.submit(q)
                    fut.add_done_callback(
                        lambda f, i=i: bat_lat.__setitem__(
                            i, time.perf_counter() - submit_at[i]))
                    futs.append(fut)
                bat_resp = [set(f.result()) for f in futs]
        assert bat_resp == seq_resp, \
            f"batched demux != sequential match sets at size {size}"
        host_nonzero = stage1_stats["nonzero_decodes"] - nz0

        qps_seq = nq / max(t_seq.seconds, 1e-9)
        qps_bat = nq / max(t_bat.seconds, 1e-9)
        rows.append({
            "batch_size": size,
            "batches": batches_per_size,
            "queries_per_s": round(qps_seq, 1),
            "p50_ms": _pct(seq_lat, 50),
            "p95_ms": _pct(seq_lat, 95),
            "batched_qps": round(qps_bat, 1),
            "batched_p50_ms": _pct(list(bat_lat.values()), 50),
            "batched_p95_ms": _pct(list(bat_lat.values()), 95),
            "speedup": round(qps_bat / qps_seq, 2),
            "super_batches": batcher.stats["super_batches"],
            "planned_pairs_per_q": round(planned / max(nq, 1), 1),
            "matches": sum(len(r) for r in seq_resp),
            "steady_compiles": steady.count + bsteady.count,
            "host_nonzero": host_nonzero,
        })
    meta = {
        "n_corpus": n, "blocks": b, "skew_s": 1.0,
        "ingest_s": round(t_ingest.seconds, 3),
        "warmup_s": round(t_warm.seconds, 3),
        "warmup_compiles": warm.count,
        "device": str(dev),
    }
    print_table(f"serve_bench — resident index on {dev}, Fig. 9 skew s=1.0 "
                f"(n={n}, b={b}), sequential vs super-batched", rows)
    print("meta:", meta)
    rows = [dict(r, **meta) for r in rows]
    save_rows("torch_serve_bench", rows)
    bad = [r for r in rows if r["steady_compiles"]]
    assert not bad, f"steady-state builds or loads: {bad}"
    bad = [r for r in rows if r["host_nonzero"]]
    assert not bad, f"host nonzero survivor scans in steady serving: {bad}"
    return rows


def counts(rows):
    """The count columns, in row order."""
    return count_view(rows, COUNTS)


def check(rows):
    """The wall-time bar: super-batching >= 3x sequential queries/s at
    the smallest micro-batch."""
    small = rows[0]
    assert small["speedup"] >= BATCHING_BAR, \
        f"super-batching speedup at micro-batch {small['batch_size']} " \
        f"fell below {BATCHING_BAR}x: {small['speedup']}"


def run(n: int = 20_000, quick: bool = False, device="cuda"):
    rows = measure(n, quick=quick, device=device)
    check(rows)
    return rows


if __name__ == "__main__":
    raise SystemExit(cli(run, __doc__))

"""Execution, single host: stage 1 (kernel cosine filter) over a lowered
catalog, stage 2 (exact edit distance) on its survivors, and the fused
entry point.

Port of the single-host half of ``repro.er.compiler.execute``:
``score_catalog`` runs the catalog through the CUDA catalog kernels in
fixed-size chunks (padded to powers of two with all-zero entries, which
keep nothing because ``r0 == r1``) and decodes each chunk's packed
survivors on the host; a chunk whose EXACT count overflows the capacity
is re-scored through the dense-mask kernel. ``verify_pairs`` is stage 2
on the device, ``match_catalog`` fuses the two. ``execute_supervised``
is the fault-tolerant supervisor: tiles scheduled onto logical device
shards, each shard scored by ``score_catalog`` on the card, failed
shards re-scheduled tile by tile. The mesh path belongs to a later
slice and raises ``NotImplementedError``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from .faults import DeviceKilledError, FaultInjector, TransientScorerError
from .feedback import N_TILE_CLASSES, EwmaCostModel, tile_class
from .ir import A_TILE, B_TILE, NCOLS, TileCatalog
from .schedule import NoHealthyDevicesError, schedule_tiles, tile_costs

__all__ = ["execute", "execute_supervised", "score_catalog", "stage1_stats",
           "verify_pairs", "match_catalog", "shard_sane", "ShardRecord",
           "SupervisedReport", "RecoveryFailedError"]


def _pad_pow2(t: int, cap: int) -> int:
    p = 1
    while p < t:
        p *= 2
    return min(p, cap)


# Host-side instrumentation of stage 1, accumulated over calls:
#   compact_decodes   — chunks decoded from the on-device packed epilogue
#   nonzero_decodes   — chunks decoded from the dense mask
#   compact_overflows — compact chunks whose exact counts exceeded the
#                       capacity, forcing the exact mask-path fallback
#   kernel_seconds    — wall time from launch until the counts (or the
#                       mask) are ready on the device
#   decode_seconds    — device→host copy of the survivors + host decode
stage1_stats: dict = {"compact_decodes": 0, "nonzero_decodes": 0,
                      "compact_overflows": 0, "kernel_seconds": 0.0,
                      "decode_seconds": 0.0}


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _decode_packed(packed: np.ndarray, counts: np.ndarray,
                   chunk: np.ndarray, bm: int, bn: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Packed (T, ≥ max count) survivor slots + exact (T,) counts → global
    (rows_a, rows_b), O(survivors) host work — no scan of dead cells."""
    tot = int(counts.sum())
    if tot == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ti = np.repeat(np.arange(counts.size), counts)
    starts = np.cumsum(counts) - counts
    slot = np.arange(tot) - np.repeat(starts, counts)
    flat = packed[ti, slot].astype(np.int64)
    rows_a = chunk[ti, A_TILE].astype(np.int64) * bm + flat // bn
    rows_b = chunk[ti, B_TILE].astype(np.int64) * bn + flat % bn
    return rows_a, rows_b


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def score_catalog(feats_a, catalog: TileCatalog, feats_b=None, *,
                  threshold: float, impl: str = "auto",
                  chunk_tiles: int = 1024, compact: bool = True,
                  compact_capacity: Optional[int] = None,
                  device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Stage 1 for a whole catalog on one device: survivor candidate pairs.

    Features (numpy or tensors) move to ``device`` once. With ``compact``
    the kernel's epilogue packs each tile's survivors on the device; only
    the exact counts and the first ``max(count)`` slots of each tile come
    back to the host, and the decode is O(survivors). ``compact_capacity``
    bounds the packed slots per tile (default bm·bn, which can never
    overflow); a chunk whose exact count exceeds it is re-scored through
    the dense mask — still exact, counted in
    ``stage1_stats['compact_overflows']``. Returns two int64 arrays.
    """
    from ...kernels import ops

    dev = resolve_device(device)
    fa = _to_device(feats_a, dev)
    fb = fa if feats_b is None else _to_device(feats_b, dev)
    tiles = catalog.tiles
    bm, bn = catalog.block_m, catalog.block_n
    capacity = compact_capacity if compact_capacity is not None else bm * bn
    out_a, out_b = [], []
    for lo in range(0, tiles.shape[0], chunk_tiles):
        chunk = tiles[lo:lo + chunk_tiles]
        padded = _pad_pow2(chunk.shape[0], chunk_tiles)
        if padded != chunk.shape[0]:
            # Empty entries: zero windows (r0 == r1) mask everything out.
            pad = np.zeros((padded - chunk.shape[0], NCOLS), np.int32)
            chunk = np.concatenate([chunk, pad], axis=0)
        chunk_t = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev)
        if compact:
            t0 = time.perf_counter()
            packed, counts = ops.pair_scores_catalog_compact(
                fa, fb, chunk_t, threshold=threshold, block_m=bm,
                block_n=bn, capacity=capacity, impl=impl)
            counts = counts.reshape(-1).cpu().numpy().astype(np.int64)
            t1 = time.perf_counter()
            stage1_stats["kernel_seconds"] += t1 - t0
            kmax = int(counts.max(initial=0))
            if kmax <= capacity:
                stage1_stats["compact_decodes"] += 1
                ra, rb = _decode_packed(packed[:, :kmax].cpu().numpy(),
                                        counts, chunk, bm, bn)
                stage1_stats["decode_seconds"] += time.perf_counter() - t1
                out_a.append(ra)
                out_b.append(rb)
                continue
            # Exact counts flagged dropped survivors: re-score this
            # chunk through the dense mask (exactness over speed).
            stage1_stats["compact_overflows"] += 1
        t0 = time.perf_counter()
        mask = ops.pair_scores_catalog(fa, fb, chunk_t, threshold=threshold,
                                       block_m=bm, block_n=bn, impl=impl)
        _sync(dev)
        t1 = time.perf_counter()
        stage1_stats["kernel_seconds"] += t1 - t0
        stage1_stats["nonzero_decodes"] += 1
        ti, ii, jj = (x.cpu().numpy()
                      for x in torch.nonzero(mask, as_tuple=True))
        out_a.append(chunk[ti, A_TILE].astype(np.int64) * bm + ii)
        out_b.append(chunk[ti, B_TILE].astype(np.int64) * bn + jj)
        stage1_stats["decode_seconds"] += time.perf_counter() - t1
    if not out_a:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(out_a), np.concatenate(out_b)


def execute(catalog: TileCatalog, feats_a, feats_b=None, *,
            threshold: float, impl: str = "auto", mesh=None,
            chunk_tiles: int = 1024, compact: bool = True,
            compact_capacity: Optional[int] = None,
            device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Stage 1 of any lowered catalog on one device: chunked
    :func:`score_catalog`. Returns host int64 (rows_a, rows_b); run
    stage 2 via :func:`verify_pairs`."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh execution is not ported yet (ROADMAP Queue 1 item 10: "
            "mesh)")
    return score_catalog(feats_a, catalog, feats_b, threshold=threshold,
                         impl=impl, chunk_tiles=chunk_tiles, compact=compact,
                         compact_capacity=compact_capacity, device=device)


# ---------------------------------------------------------------------------
# Supervised stage 1: tile-granular fault recovery
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardRecord:
    """One per-device-shard completion record, the supervisor's ledger."""
    round: int
    device: int
    tiles: int
    cost: int                  # live pairs the shard was responsible for
    status: str                # ok | killed | transient | timeout | corrupt
    elapsed: float             # REAL wall seconds of the shard call
    injected_delay: float = 0.0  # virtual straggle seconds (injector only)

    @property
    def busy(self) -> float:
        """Simulated device-busy seconds: real wall time plus the
        injected virtual delay. Deadlines, the makespan clock and the
        feedback model run on busy time; latency *statistics* must use
        ``elapsed`` so chaos scripts don't poison them."""
        return self.elapsed + self.injected_delay


@dataclass
class SupervisedReport:
    """What happened during one :func:`execute_supervised` run."""
    rounds: int = 0            # scheduling rounds executed (1 == quiet run)
    recovered_tiles: int = 0   # tiles that succeeded on a retry round
    planned_cost: int = 0      # live pairs the catalog plans
    scored_cost: int = 0       # live pairs covered by accepted shards
    lost_tiles: int = 0        # tiles never scored (degraded mode only)
    steals: int = 0            # mid-stream re-LPT events (slow devices)
    stolen_tiles: int = 0      # queued tiles moved off slow devices
    predicted_makespan_s: float = 0.0  # calibrated round-1 projection
    measured_makespan_s: float = 0.0   # Σ rounds max device busy-time
    records: List[ShardRecord] = field(default_factory=list)
    backoffs: List[float] = field(default_factory=list)
    healthy: Optional[np.ndarray] = None   # final device mask

    @property
    def retries(self) -> int:
        return max(self.rounds - 1, 0)

    @property
    def coverage(self) -> float:
        """Fraction of planned live pairs actually scored — 1.0 after a
        full recovery, < 1.0 only in degraded (partial) mode."""
        if self.planned_cost == 0:
            return 1.0
        return self.scored_cost / self.planned_cost


class RecoveryFailedError(RuntimeError):
    """Retries/deadline exhausted with tiles still unscored (and the
    caller did not opt into partial results). Carries the report."""

    def __init__(self, msg: str, report: SupervisedReport):
        super().__init__(msg)
        self.report = report


def shard_sane(rows_a: np.ndarray, rows_b: np.ndarray,
               n_a: int, n_b: int) -> bool:
    """Cheap survivor sanity check: paired 1-D int arrays, every index in
    bounds. Any corrupted shard from :meth:`FaultInjector.corrupt_output`
    fails this by construction; a real deployment would run the same
    check on rows coming back over the wire."""
    if rows_a.shape != rows_b.shape or rows_a.ndim != 1:
        return False
    if rows_a.size == 0:
        return True
    return bool((rows_a >= 0).all() and (rows_a < n_a).all()
                and (rows_b >= 0).all() and (rows_b < n_b).all())


def _sub_catalog(catalog: TileCatalog, idx: np.ndarray) -> TileCatalog:
    return TileCatalog(tiles=catalog.tiles[idx], block_m=catalog.block_m,
                       block_n=catalog.block_n, n_rows_a=catalog.n_rows_a,
                       n_rows_b=catalog.n_rows_b, r=catalog.r,
                       total_pairs=catalog.total_pairs)


def execute_supervised(catalog: TileCatalog, feats_a, feats_b=None, *,
                       threshold: float, n_dev: int = 1,
                       healthy: Optional[np.ndarray] = None,
                       impl: str = "auto", chunk_tiles: int = 1024,
                       policy: str = "cost_lpt",
                       injector: Optional[FaultInjector] = None,
                       shard_deadline: Optional[float] = None,
                       deadline: Optional[float] = None,
                       max_retries: int = 3, backoff: float = 0.05,
                       backoff_factor: float = 2.0, sleep=time.sleep,
                       partial: bool = False,
                       feedback: Optional[EwmaCostModel] = None,
                       steal_factor: Optional[float] = None,
                       steal_quantum: Optional[int] = None,
                       compact: bool = True,
                       compact_capacity: Optional[int] = None,
                       device="cuda"
                       ) -> Tuple[np.ndarray, np.ndarray, SupervisedReport]:
    """Stage 1 with tile-granular fault recovery over logical devices.

    The catalog's tiles are cost-LPT scheduled onto ``n_dev`` logical
    device shards; the host drives each shard through
    :func:`score_catalog` on ``device`` (on a real cluster each shard
    call is the per-device RPC). Features move to ``device`` once; each
    shard's time ends when its survivors are on the host, so a shard's
    ``perf_counter`` time is device time plus the host decode. Every
    shard produces a completion record; shards that fail (killed
    device), time out (wall + injected latency > ``shard_deadline``),
    raise transiently, or return survivors that fail
    :func:`shard_sane` are DISCARDED, their device is masked out
    where the failure indicates device loss (kill/timeout), and ONLY the
    lost tiles are re-scheduled over the shrunken healthy mask — at most
    ``max_retries`` extra rounds with exponential backoff
    (``backoff * backoff_factor**k``, each sleep clamped to the
    remaining wall ``deadline``).

    **Runtime feedback.** Pass ``feedback=`` (an :class:`EwmaCostModel`)
    and every accepted shard call trains the model, and every round's
    ``schedule_tiles`` is calibrated by it (wall-clock-weighted tile
    packing, heterogeneous device placement). Pass ``steal_factor=`` to
    enable mid-stream work stealing: each device's round work is split
    into ``steal_quantum``-tile batches (one batch per device when
    unset), dispatch follows per-device virtual busy-time clocks (the
    idle-device-next simulation of a parallel fleet), and after every
    completed call a device whose projected finish exceeds
    ``steal_factor ×`` the fleet's median projection has its *queued*
    (never in-flight) batches re-placed greedily onto the
    fastest-projected other devices. Stolen tiles were not yet scored,
    so exactly-once merging is untouched.

    Survivors merge idempotently: the catalog covers each planned pair
    exactly once and results from failed shards are never merged, so
    re-executing a tile cannot double-count — the final
    ``np.unique`` over (row_a, row_b) makes recovery exactly-once at the
    match-set level even if a future policy merges late stragglers.

    ``deadline`` bounds the whole call (seconds); on exhaustion —
    or when retries run out, or every device dies — the call either
    raises :class:`RecoveryFailedError` / :class:`NoHealthyDevicesError`
    or, with ``partial=True``, returns what it has with
    ``report.coverage < 1`` (the service's graceful-degradation mode).

    Returns ``(rows_a, rows_b, report)`` — deduplicated host int64
    survivor candidates plus the :class:`SupervisedReport`.
    """
    t_start = time.perf_counter()
    dev = resolve_device(device)
    feats_a = _to_device(feats_a, dev)
    if feats_b is not None:
        feats_b = _to_device(feats_b, dev)
    if healthy is None:
        healthy = np.ones(n_dev, bool)
    healthy = np.asarray(healthy, bool).copy()
    if steal_factor is not None and feedback is None:
        feedback = EwmaCostModel(n_dev)
    costs = tile_costs(catalog)
    classes = tile_class(catalog) if feedback is not None else None
    report = SupervisedReport(planned_cost=int(costs.sum()), healthy=healthy)
    out_a: List[np.ndarray] = [np.zeros(0, np.int64)]
    out_b: List[np.ndarray] = [np.zeros(0, np.int64)]
    pending = np.arange(catalog.num_tiles, dtype=np.int64)
    n_a, n_b = catalog.n_rows_a, catalog.n_rows_b

    def _out_of_time() -> bool:
        return (deadline is not None
                and time.perf_counter() - t_start >= deadline)

    def _predict(dev: int, batch: np.ndarray) -> float:
        return feedback.predict_tiles(dev, costs[batch], classes[batch])

    def _steal_pass(queues, clocks) -> None:
        """Re-place every queued batch of over-projected devices onto the
        fastest-projected peers (greedy, largest batch first)."""
        proj = {}
        for k in clocks:
            proj[k] = clocks[k] + sum(_predict(k, b)
                                      for b in queues.get(k, ()))
        med = float(np.median(list(proj.values())))
        victims = [k for k in list(queues)
                   if proj[k] > steal_factor * max(med, 1e-9)]
        for v in victims:
            if len(clocks) < 2:
                return
            batches = queues.pop(v)
            report.steals += 1
            proj[v] = clocks[v]
            batches.sort(key=lambda b: -float(costs[b].sum()))
            for b in batches:
                dst = min((k for k in clocks if k != v),
                          key=lambda k: (proj[k] + _predict(k, b), k))
                queues.setdefault(dst, []).append(b)
                proj[dst] += _predict(dst, b)
                report.stolen_tiles += int(b.size)

    while pending.size:
        if report.rounds > max_retries or _out_of_time():
            break
        if report.rounds:                       # retry round: back off
            b = backoff * backoff_factor ** (report.rounds - 1)
            if deadline is not None:            # never sleep past deadline
                b = min(b, max(deadline - (time.perf_counter() - t_start),
                               0.0))
            report.backoffs.append(b)
            if b > 0:
                sleep(b)
            if _out_of_time():                  # re-check: sleep spent it
                break
        report.rounds += 1
        sub = _sub_catalog(catalog, pending)
        try:
            sched = schedule_tiles(sub, n_dev=n_dev, healthy=healthy,
                                   policy=policy, feedback=feedback)
        except NoHealthyDevicesError:
            if partial:
                break
            report.lost_tiles = int(pending.size)
            raise
        if report.rounds == 1 and sched.calibrated:
            report.predicted_makespan_s = float(np.max(sched.predicted_s))
        dev_of_tile = sched.reducer_device[sched.tile_reducer]
        lost: List[np.ndarray] = []
        # Per-device FIFO queues of quantum-sized batches plus virtual
        # busy-time clocks; dispatching to the min-clock device (lowest
        # id on ties) simulates a parallel fleet — with one batch per
        # device and zeroed clocks it reproduces the classic ascending-
        # device-order call sequence exactly.
        queues: dict = {}
        clocks: dict = {}
        for d in np.flatnonzero(healthy):
            d = int(d)
            clocks[d] = 0.0
            mine = pending[dev_of_tile == d]
            if mine.size == 0:
                continue
            if steal_quantum:
                queues[d] = [mine[lo:lo + steal_quantum]
                             for lo in range(0, mine.size, steal_quantum)]
            else:
                queues[d] = [mine]
        round_makespan = 0.0
        while queues:
            if _out_of_time():
                for q in queues.values():
                    lost.extend(q)
                queues.clear()
                break
            d = min(queues, key=lambda k: (clocks[k], k))
            mine = queues[d].pop(0)
            if not queues[d]:
                del queues[d]
            cost = int(costs[mine].sum())
            t0 = time.perf_counter()
            status, extra = "ok", 0.0
            ra = rb = None
            try:
                plan = injector.shard_call(d) if injector else None
                ra, rb = score_catalog(
                    feats_a, _sub_catalog(catalog, mine), feats_b,
                    threshold=threshold, impl=impl,
                    chunk_tiles=chunk_tiles, compact=compact,
                    compact_capacity=compact_capacity, device=dev)
                if plan is not None:
                    extra = plan.delay
                    if plan.corrupt:
                        ra, rb = injector.corrupt_output(ra, rb, n_a, n_b)
            except DeviceKilledError:
                status = "killed"
            except TransientScorerError:
                status = "transient"
            elapsed = time.perf_counter() - t0
            busy = elapsed + extra
            if status == "ok":
                if shard_deadline is not None and busy > shard_deadline:
                    status = "timeout"          # straggler: discard output
                elif not shard_sane(ra, rb, n_a, n_b):
                    status = "corrupt"          # failed the sanity check
            report.records.append(ShardRecord(
                round=report.rounds, device=d, tiles=int(mine.size),
                cost=cost, status=status, elapsed=elapsed,
                injected_delay=extra))
            clocks[d] += busy
            round_makespan = max(round_makespan, clocks[d])
            if status == "ok":
                out_a.append(ra)
                out_b.append(rb)
                report.scored_cost += cost
                if report.rounds > 1:
                    report.recovered_tiles += int(mine.size)
                if feedback is not None and cost > 0:
                    feedback.observe(
                        d, np.bincount(classes[mine], weights=costs[mine],
                                       minlength=N_TILE_CLASSES), busy)
            else:
                lost.append(mine)
                if status in ("killed", "timeout"):
                    healthy[d] = False          # device-level failure
                    lost.extend(queues.pop(d, []))
                    clocks.pop(d, None)
            if (steal_factor is not None and feedback is not None
                    and feedback.observations >= 1
                    and queues and len(clocks) > 1):
                _steal_pass(queues, clocks)
        report.measured_makespan_s += round_makespan
        pending = (np.concatenate(lost) if lost
                   else np.zeros(0, np.int64))

    report.lost_tiles = int(pending.size)
    report.healthy = healthy
    if pending.size and not partial:
        raise RecoveryFailedError(
            f"{pending.size} tiles unscored after {report.retries} retries",
            report)
    ra = np.concatenate(out_a)
    rb = np.concatenate(out_b)
    if ra.size:                                 # exactly-once at the
        pairs = np.unique(np.stack([ra, rb], axis=1), axis=0)   # match level
        ra, rb = pairs[:, 0], pairs[:, 1]
    return ra, rb, report


_VERIFY_CHUNK = 8_192


def verify_pairs(codes_a, lens_a, codes_b, lens_b, rows_a, rows_b,
                 threshold: float, chunk: int = _VERIFY_CHUNK,
                 device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Stage 2: exact normalized edit similarity >= threshold on candidate
    row pairs, in chunks of ``chunk`` pairs on ``device``. Codes and
    lengths (numpy or tensors) move to the device once; the similarities
    come back as f32 and are compared with the threshold on the host, as
    in the JAX package."""
    from ..similarity import edit_similarity

    dev = resolve_device(device)
    ca, la = _to_device(codes_a, dev), _to_device(lens_a, dev)
    if codes_b is codes_a and lens_b is lens_a:
        cb, lb = ca, la
    else:
        cb, lb = _to_device(codes_b, dev), _to_device(lens_b, dev)
    rows_a = np.asarray(rows_a, np.int64)
    rows_b = np.asarray(rows_b, np.int64)
    hit_a, hit_b = [], []
    for lo in range(0, rows_a.shape[0], chunk):
        a = rows_a[lo:lo + chunk]
        b = rows_b[lo:lo + chunk]
        ia = torch.from_numpy(a).to(dev)
        ib = torch.from_numpy(b).to(dev)
        sim = edit_similarity(ca[ia], la[ia], cb[ib], lb[ib]).cpu().numpy()
        sel = np.flatnonzero(sim >= threshold)
        hit_a.append(a[sel])
        hit_b.append(b[sel])
    if not hit_a:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(hit_a), np.concatenate(hit_b)


def match_catalog(catalog: TileCatalog, feats_a, codes_a, lens_a, *,
                  feats_b=None, codes_b=None, lens_b=None,
                  threshold: float = 0.8, filter_margin: float = 0.25,
                  impl: str = "auto", mesh=None, chunk_tiles: int = 1024,
                  compact_capacity: Optional[int] = None,
                  device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Fused filter-and-verify: kernel stage 1 over the tile catalog,
    exact stage 2 on its survivors. Returns matched (rows_a, rows_b) —
    indices into the a-side (and b-side, if distinct) arrays."""
    cand_a, cand_b = execute(
        catalog, feats_a, feats_b, threshold=threshold - filter_margin,
        impl=impl, mesh=mesh, chunk_tiles=chunk_tiles,
        compact_capacity=compact_capacity, device=device)
    if codes_b is None:
        codes_b, lens_b = codes_a, lens_a
    return verify_pairs(codes_a, lens_a, codes_b, lens_b, cand_a, cand_b,
                        threshold, device=device)

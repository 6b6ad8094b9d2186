"""End-to-end ER pipeline on one device — the paper's Fig. 2 workflow.

Port of ``repro.er.pipeline``. Job 1 is the blocking keys + block
distribution matrix (BDM) on the host, or the Sorted Neighborhood sort.
Job 2 runs every strategy through one path:

    plan → plan_to_job → lower → schedule_tiles → execute → verify

with stage 1 on the CUDA catalog kernels and stage 2 on the device.
``ERConfig.executor = "reference"`` keeps the per-reducer materialized
pair lists (paired dots + the same verifier) as the parity oracle.
Entities without a blocking key (block id −1) go through the match_⊥
cross job (paper §III, Appendix I); SN has none.

Options of later slices raise ``NotImplementedError`` naming their
ROADMAP item: a mesh, supervised or fault-injected runs, runtime
feedback, tile autotuning and non-flat comms.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core import (
    blocked_layout,
    compute_bdm,
    entity_indices,
    plan_basic,
    plan_block_split,
    plan_pair_range,
    pairs_of_range,
)
from ..core.basic import BasicPlan
from ..core.block_split import BlockSplitPlan
from ..core.pair_range import PairRangePlan, map_output_size as pair_range_map_output_size
from ..core.sorted_neighborhood import (
    SortedNeighborhoodPlan,
    map_output_size as sn_map_output_size,
    pairs_of_band_range,
    plan_sorted_neighborhood,
)
from ..core.two_source import TwoSourceBDM, plan_pair_range_2src, pairs_of_range_2src
from ..device import resolve_device
from ..kernels.ops import IMPLS
from .blocking import prefix_block_ids, sn_sort_order
from .encode import encode_titles, ngram_features
from .compiler import (Schedule, TileCatalog, apply_schedule, cross_job,
                       enumerate_task_pairs, lower, plan_to_job,
                       schedule_tiles, stage1_stats)
from .compiler.execute import execute, verify_pairs

__all__ = ["ERConfig", "ERResult", "JobPlan", "run_er", "plan_job",
           "compile_catalog", "featurize", "cross_restrict"]

_CHUNK = 65_536


def featurize(titles: Sequence[str], cfg) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(codes, lens) for the exact stage-2 verifier plus the hashed n-gram
    filter features, all numpy. ``cfg`` needs ``max_len`` and
    ``feature_dim``."""
    codes, lens = encode_titles(titles, max_len=cfg.max_len)
    feats = ngram_features(codes, dim=cfg.feature_dim, lengths=lens)
    return codes, lens, feats


def cross_restrict(matches: Set[Tuple[int, int]],
                   n_left: int) -> Set[Tuple[int, int]]:
    """Restrict a ``run_er`` match set over ``left ++ right`` to cross
    pairs, re-based as (left_idx, right_local_idx)."""
    return {(a, b - n_left) for a, b in matches if a < n_left <= b}


@dataclass
class ERConfig:
    strategy: str = "pair_range"       # basic | block_split | pair_range
                                       # | sorted_neighborhood
    r: int = 32                        # reduce tasks
    m: int = 8                         # map tasks / input partitions
    threshold: float = 0.8
    prefix_len: int = 3
    window: int = 10                   # SN sliding-window size w
    feature_dim: int = 256
    max_len: int = 64
    filter_margin: float = 0.25
    match_missing_keys: bool = True
    executor: str = "catalog"          # catalog | reference
    block_m: int = 128                 # catalog tile rows
    block_n: int = 128                 # catalog tile cols
    tune_tiles: bool = False           # True: ROADMAP Queue 1 item 7
    kernel_impl: str = "auto"          # auto | cuda | torch
    schedule_policy: str = "cost_lpt"  # cost_lpt | round_robin
    comms: str = "flat"                # other policies: Queue 1 item 10
    supervised_devices: int = 0        # > 0: Queue 1 item 8
    compact_capacity: Optional[int] = None  # packed slots per tile;
                                            # None = bm·bn (never overflows)


@dataclass
class ERResult:
    matches: Set[Tuple[int, int]]
    total_pairs: int
    reducer_pairs: np.ndarray          # (r,) planned pair loads
    map_output_size: int               # kv-pairs emitted by map (Fig. 12)
    bdm_seconds: float                 # Job-1 time (BDM, or the SN sort)
    reducer_seconds: np.ndarray        # (r,) measured matching time
    extra: Dict = field(default_factory=dict)
    config: Optional[ERConfig] = None  # the (fresh) config this run used
    schedule: Optional[Dict] = None    # Schedule.stats() (catalog executor)

    @property
    def makespan_seconds(self) -> float:
        return float(self.reducer_seconds.max()) if self.reducer_seconds.size else 0.0


def _match_pairs_chunked(feats, codes, lens, rows_a, rows_b, threshold,
                         margin, device) -> Tuple[np.ndarray, np.ndarray]:
    """REFERENCE executor (``ERConfig.executor = "reference"``): filter-
    and-verify over materialized (rows_a, rows_b). Stage 1 is a paired
    f32 dot on the device, compared with the threshold on the host; stage
    2 the exact verifier."""
    cand_a, cand_b = [], []
    for lo in range(0, rows_a.shape[0], _CHUNK):
        a = rows_a[lo:lo + _CHUNK]
        b = rows_b[lo:lo + _CHUNK]
        ia = torch.from_numpy(a).to(device)
        ib = torch.from_numpy(b).to(device)
        cos = (feats[ia] * feats[ib]).sum(dim=1).cpu().numpy()
        sel = np.flatnonzero(cos >= threshold - margin)
        cand_a.append(a[sel])
        cand_b.append(b[sel])
    ca = np.concatenate(cand_a) if cand_a else np.zeros(0, np.int64)
    cb = np.concatenate(cand_b) if cand_b else np.zeros(0, np.int64)
    return verify_pairs(codes, lens, codes, lens, ca, cb, threshold,
                        device=device)


def _reference_reducer_rows(plan, r: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Materialized per-reducer (rows_a, rows_b) for the reference
    executor — the O(P) path the catalog replaces."""
    rows: List[Tuple[np.ndarray, np.ndarray]] = [
        (np.zeros(0, np.int64), np.zeros(0, np.int64)) for _ in range(r)]

    def add(k, ra, rb):
        pa, pb = rows[k]
        rows[k] = (np.concatenate([pa, ra]), np.concatenate([pb, rb]))

    if isinstance(plan, PairRangePlan):
        for k in range(r):
            _, _, _, ra, rb = pairs_of_range(plan, k)
            rows[k] = (ra, rb)
    elif isinstance(plan, SortedNeighborhoodPlan):
        for k in range(r):
            ra, rb = pairs_of_band_range(plan, k)
            rows[k] = (ra, rb)
    elif isinstance(plan, BlockSplitPlan):
        for t in range(plan.task_block.shape[0]):
            ra, rb = enumerate_task_pairs(
                int(plan.task_a_start[t]), int(plan.task_a_len[t]),
                int(plan.task_b_start[t]), int(plan.task_b_len[t]),
                bool(plan.task_triangular[t]))
            add(int(plan.task_reducer[t]), ra, rb)
    elif isinstance(plan, BasicPlan):
        sizes = plan.block_sizes
        estart = np.concatenate([np.zeros(1, np.int64), np.cumsum(sizes)[:-1]])
        for k_blk in np.flatnonzero(sizes >= 2):
            ra, rb = enumerate_task_pairs(
                int(estart[k_blk]), int(sizes[k_blk]), 0, 0, True)
            add(int(plan.block_reducer[k_blk]), ra, rb)
    else:
        raise TypeError(f"no reference enumeration for {type(plan).__name__}")
    return rows


def _not_ported(cfg: ERConfig, fault_injector, feedback, mesh) -> None:
    """Options of later slices raise, naming their ROADMAP Queue 1 item."""
    todo = []
    if mesh is not None:
        todo.append("mesh= (item 10: mesh)")
    if cfg.comms != "flat":
        todo.append(f"comms={cfg.comms!r} (item 10: mesh)")
    if cfg.supervised_devices > 0:
        todo.append("supervised_devices > 0 (item 8: supervisor)")
    if fault_injector is not None:
        todo.append("fault_injector= (item 8: supervisor)")
    if feedback is not None:
        todo.append("feedback= (item 7: tuning and feedback)")
    if cfg.tune_tiles:
        todo.append("tune_tiles=True (item 7: tuning and feedback)")
    if todo:
        raise NotImplementedError(
            "not ported yet, see ROADMAP Queue 1: " + "; ".join(todo))


@dataclass
class JobPlan:
    """Job 1 and the strategy's plan, as ``run_er`` runs them."""
    plan: object                       # the strategy's plan
    to_global: np.ndarray              # blocked (or sorted) row → entity id
    null_idx: Optional[np.ndarray]     # entities without a blocking key
    map_output_size: int
    bdm_seconds: float                 # Job-1 time (BDM, or the SN sort)
    extra: Dict = field(default_factory=dict)


def plan_job(titles: Sequence[str], cfg: ERConfig,
             block_ids: Optional[np.ndarray] = None) -> JobPlan:
    """Job 1 (prefix blocking + BDM, or the SN sort) and the plan of
    ``cfg.strategy`` — the only strategy-aware stage of ``run_er``."""
    n = len(titles)
    null_idx: Optional[np.ndarray] = None
    extra: Dict = {}
    if cfg.strategy == "sorted_neighborhood":
        t0 = time.perf_counter()
        to_global = sn_sort_order(titles)
        plan = plan_sorted_neighborhood(n, cfg.window, cfg.r)
        bdm_seconds = time.perf_counter() - t0
        map_out = sn_map_output_size(plan)
        extra.update(window=cfg.window, w_eff=plan.w_eff)
    elif cfg.strategy in ("basic", "block_split", "pair_range"):
        if block_ids is None:
            block_ids, _ = prefix_block_ids(titles, k=cfg.prefix_len)
        block_ids = np.asarray(block_ids, np.int64)

        # Input partitions: m contiguous row ranges (HDFS-split analog).
        part_ids = np.minimum(
            np.arange(n, dtype=np.int64) * cfg.m // max(n, 1), cfg.m - 1)

        keyed = block_ids >= 0
        keyed_idx = np.flatnonzero(keyed)
        if (~keyed).any():
            null_idx = np.flatnonzero(~keyed)

        # ---- Job 1: BDM ----
        t0 = time.perf_counter()
        kb = block_ids[keyed_idx]
        kp = part_ids[keyed_idx]
        num_blocks = int(kb.max()) + 1 if kb.size else 0
        bdm = compute_bdm(kb, kp, num_blocks, cfg.m)
        eidx = entity_indices(kb, kp, bdm)
        bdm_seconds = time.perf_counter() - t0

        sizes = bdm.sum(axis=1)
        perm, _ = blocked_layout(kb, eidx, sizes)
        # perm[blocked_row] = row within keyed_idx → global entity ids.
        to_global = keyed_idx[perm]

        if cfg.strategy == "pair_range":
            plan = plan_pair_range(bdm, cfg.r)
            map_out = pair_range_map_output_size(plan)
        elif cfg.strategy == "block_split":
            plan = plan_block_split(bdm, cfg.r)
            map_out = plan.map_output_size()
        else:
            plan = plan_basic(bdm, cfg.r)
            map_out = plan.map_output_size()
    else:
        raise ValueError(f"unknown strategy {cfg.strategy!r}")
    return JobPlan(plan=plan, to_global=to_global, null_idx=null_idx,
                   map_output_size=int(map_out), bdm_seconds=bdm_seconds,
                   extra=extra)


def compile_catalog(plan, cfg: ERConfig) -> Tuple[TileCatalog, Schedule]:
    """``plan_to_job → lower → schedule_tiles``: the tile catalog the
    catalog executor scores, in scheduled order, and its schedule."""
    catalog = lower(plan_to_job(plan), cfg.block_m, cfg.block_n)
    sched = schedule_tiles(catalog, n_dev=1, policy=cfg.schedule_policy)
    return apply_schedule(catalog, sched), sched


def run_er(titles: Sequence[str], config: Optional[ERConfig] = None,
           block_ids: Optional[np.ndarray] = None,
           fault_injector=None, feedback=None, mesh=None,
           axis: str = "data", *, device="cuda") -> ERResult:
    """Match a single source on ``device``. ``block_ids`` overrides prefix
    blocking (ignored by ``strategy="sorted_neighborhood"``).

    ``config=None`` builds a fresh default ``ERConfig`` per call; the
    resolved config is returned on ``ERResult.config``. Seconds per stage
    land on ``ERResult.extra["timings"]``; on the card each stage ends in
    a synchronize.
    """
    del axis
    t_start = time.perf_counter()
    n = len(titles)
    cfg = config if config is not None else ERConfig()
    if cfg.executor not in ("catalog", "reference"):
        raise ValueError(f"unknown executor {cfg.executor!r}")
    if cfg.kernel_impl not in IMPLS:
        raise ValueError(f"unknown kernel_impl {cfg.kernel_impl!r}")
    _not_ported(cfg, fault_injector, feedback, mesh)
    dev = resolve_device(device)

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    timings: Dict[str, float] = {}
    t0 = time.perf_counter()
    codes, lens, feats = featurize(titles, cfg)
    timings["featurize_s"] = time.perf_counter() - t0

    extra: Dict = {"timings": timings}

    # ---- Job 1 + plan: the ONLY strategy-aware stage ----
    t_plan = time.perf_counter()
    jp = plan_job(titles, cfg, block_ids)
    plan, to_global, null_idx = jp.plan, jp.to_global, jp.null_idx
    bdm_seconds, map_out = jp.bdm_seconds, jp.map_output_size
    extra.update(jp.extra)
    timings["job1_s"] = bdm_seconds

    reducer_pairs = np.asarray(plan.reducer_pairs, np.int64)
    total = int(plan.total_pairs)
    matches: Set[Tuple[int, int]] = set()
    reducer_seconds = np.zeros(cfg.r)
    sched_report: Optional[Dict] = None

    if cfg.executor == "catalog":
        catalog, sched = compile_catalog(plan, cfg)
        extra["catalog_tiles"] = catalog.num_tiles
        sched_report = sched.stats()
    timings["plan_s"] = time.perf_counter() - t_plan - bdm_seconds

    # ---- features and codes in blocked (or sorted) order, on the device
    t0 = time.perf_counter()
    g_feats = torch.from_numpy(feats[to_global]).to(dev)
    g_codes = torch.from_numpy(codes[to_global]).to(dev)
    g_lens = torch.from_numpy(lens[to_global]).to(dev)
    _sync()
    timings["upload_s"] = time.perf_counter() - t0

    # ---- Job 2: reduce-phase matching (one path for every strategy) ----
    if cfg.executor == "catalog":
        s1 = dict(stage1_stats)
        t0 = time.perf_counter()
        ca, cb = execute(catalog, g_feats,
                         threshold=cfg.threshold - cfg.filter_margin,
                         impl=cfg.kernel_impl,
                         compact_capacity=cfg.compact_capacity, device=dev)
        t1 = time.perf_counter()
        ha, hb = verify_pairs(g_codes, g_lens, g_codes, g_lens, ca, cb,
                              cfg.threshold, device=dev)
        _sync()
        t2 = time.perf_counter()
        timings["stage1_s"] = stage1_stats["kernel_seconds"] - s1["kernel_seconds"]
        timings["decode_s"] = stage1_stats["decode_seconds"] - s1["decode_seconds"]
        timings["stage2_s"] = t2 - t1
        extra["candidates"] = int(ca.size)
        for a, b in zip(to_global[ha], to_global[hb]):
            matches.add((min(int(a), int(b)), max(int(a), int(b))))
        if total:
            # Wall time attributed to reducers by planned load.
            reducer_seconds = ((t2 - t0) * reducer_pairs.astype(np.float64)
                               / total)
    else:
        t_ref = time.perf_counter()
        for k, (ra, rb) in enumerate(_reference_reducer_rows(plan, cfg.r)):
            if ra.size == 0:
                continue
            t0 = time.perf_counter()
            ha, hb = _match_pairs_chunked(
                g_feats, g_codes, g_lens, ra, rb,
                cfg.threshold, cfg.filter_margin, dev)
            reducer_seconds[k] = time.perf_counter() - t0
            for a, b in zip(to_global[ha], to_global[hb]):
                matches.add((min(int(a), int(b)), max(int(a), int(b))))
        timings["reference_s"] = time.perf_counter() - t_ref

    # ---- match_⊥(R, R_∅): entities without blocking key vs everyone ----
    if cfg.match_missing_keys and null_idx is not None and null_idx.size:
        t_cross = time.perf_counter()
        bdm2 = TwoSourceBDM(
            bdm_r=np.full((1, 1), n, np.int64),
            bdm_s=np.full((1, 1), null_idx.size, np.int64))
        plan2 = plan_pair_range_2src(bdm2, cfg.r)
        extra["null_key_pairs"] = plan2.total_pairs
        feats_t = torch.from_numpy(feats).to(dev)
        codes_t = torch.from_numpy(codes).to(dev)
        lens_t = torch.from_numpy(lens).to(dev)
        null_t = torch.from_numpy(null_idx).to(dev)
        if cfg.executor == "catalog":
            cross = lower(cross_job(n, int(null_idx.size), cfg.r),
                          cfg.block_m, cfg.block_n)
            ca, cb = execute(cross, feats_t, feats_t[null_t],
                             threshold=cfg.threshold - cfg.filter_margin,
                             impl=cfg.kernel_impl,
                             compact_capacity=cfg.compact_capacity,
                             device=dev)
            ha, hb = verify_pairs(codes_t, lens_t, codes_t[null_t],
                                  lens_t[null_t], ca, cb, cfg.threshold,
                                  device=dev)
            hits = [(ha, null_idx[hb])]
        else:
            hits = []
            for k in range(cfg.r):
                _, _, _, rr, rs = pairs_of_range_2src(plan2, k)
                if rr.size == 0:
                    continue
                hits.append(_match_pairs_chunked(
                    feats_t, codes_t, lens_t, rr, null_idx[rs],
                    cfg.threshold, cfg.filter_margin, dev))
        for ha, hb in hits:
            for a, b in zip(ha, hb):
                a, b = int(a), int(b)
                if a != b:
                    matches.add((min(a, b), max(a, b)))
        total += plan2.total_pairs
        _sync()
        timings["cross_s"] = time.perf_counter() - t_cross

    _sync()
    timings["total_s"] = time.perf_counter() - t_start
    return ERResult(
        matches=matches,
        total_pairs=int(total),
        reducer_pairs=reducer_pairs,
        map_output_size=int(map_out),
        bdm_seconds=bdm_seconds,
        reducer_seconds=reducer_seconds,
        extra=extra,
        config=cfg,
        schedule=sched_report,
    )

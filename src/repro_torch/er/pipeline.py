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

``ERConfig.tune_tiles`` picks each job's tile geometry with the
occupancy autotuner; ``supervised_devices`` / ``fault_injector=`` run
stage 1 through the fault-tolerant supervisor, calibrated by
``feedback=``; ``mesh=`` (a :class:`~repro_torch.sharding.Mesh`) scores
the main job's catalog on a device mesh with the ``ERConfig.comms``
gather and, when the mesh's ``model`` axis is larger than 1, the feature
dimension sharded over it.
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
from ..device import resolve_device, synchronize
from ..kernels import ngram, ops
from ..sharding import shard_rows
from .blocking import prefix_block_ids, sn_sort_order
from .encode import encode_titles
from . import trace
from .compiler import (COMMS_POLICIES, EwmaCostModel, MatchJob, Schedule,
                       TileCatalog, apply_schedule, autotune, cross_job,
                       enumerate_task_pairs, execute_supervised, lower,
                       plan_comms, plan_to_job, schedule_tiles)
from .compiler.execute import execute, verify_pairs

__all__ = ["ERConfig", "ERResult", "JobPlan", "run_er", "plan_job",
           "compile_catalog", "featurize", "cross_restrict", "encode_stats"]

_CHUNK = 65_536

# Host-side instrumentation of featurization, accumulated over calls: calls
# of :func:`featurize` and the titles they featurized, on the CUDA kernel
# route (``kernels/ngram.py``, one launch a call) and on the NumPy route
# (``encode.ngram_features``).
encode_stats: dict = {"kernel_calls": 0, "kernel_rows": 0,
                      "plain_calls": 0, "plain_rows": 0}


def featurize(titles: Sequence[str], cfg, device=None):
    """(codes, lens) for the exact stage-2 verifier plus the hashed n-gram
    filter features. ``cfg`` needs ``max_len`` and ``feature_dim``; its
    ``kernel_impl`` (default "auto") picks the route for ``device``.

    Without ``device`` the NumPy route makes them on the host and all
    three are NumPy, whatever ``kernel_impl`` says. With one, all three
    are tensors on it, in input order: on a CUDA device the codes and
    lengths go up once and the n-gram kernel makes the features there; on
    a CPU device or under ``kernel_impl="torch"`` the NumPy route makes
    them on the host. Both routes give the same features bit for bit."""
    codes, lens = encode_titles(titles, max_len=cfg.max_len)
    dev = None if device is None else resolve_device(device)
    on_card = dev is not None and ops.resolve_impl(
        getattr(cfg, "kernel_impl", "auto"), dev) == "cuda"
    home = dev if on_card else torch.device("cpu")
    codes_t = torch.from_numpy(codes).to(home)
    lens_t = torch.from_numpy(lens).to(home)
    feats = ngram.ngram_features(codes_t, lens_t, dim=cfg.feature_dim,
                                 impl="cuda" if on_card else "torch")
    route = "kernel" if on_card else "plain"
    encode_stats[f"{route}_calls"] += 1
    encode_stats[f"{route}_rows"] += len(codes)
    if device is None:
        return codes, lens, feats.numpy()
    synchronize([dev])
    return codes_t.to(dev), lens_t.to(dev), feats.to(dev)


def _collect(matches: Set[Tuple[int, int]], hits) -> None:
    """Add stage 2's hits, ``(a, b)`` arrays of entity ids, to
    ``matches`` as ``(min, max)`` tuples of ints, leaving out a == b (the
    match_⊥ job's self pairs), in the span ``pipeline.collect``."""
    with trace.span("pipeline.collect"):
        for a, b in hits:
            keep = a != b
            a, b = a[keep], b[keep]
            matches.update(zip(np.minimum(a, b).tolist(),
                               np.maximum(a, b).tolist()))


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
    tune_tiles: bool = False           # pick (block_m, block_n) per job
                                       # via compiler.autotune (catalog
                                       # executor; overrides block_m/n)
    kernel_impl: str = "auto"          # auto | cuda | torch
    schedule_policy: str = "cost_lpt"  # cost_lpt | round_robin
    comms: str = "flat"                # mesh= gather policy: flat | ring
                                       # | hierarchical (ignored without
                                       # a mesh)
    # ---- fault-tolerant execution (catalog executor only) ----
    supervised_devices: int = 0        # > 0: stage 1 through the supervisor
                                       # on N logical device shards
    max_retries: int = 3               # recovery rounds per supervised job
    shard_deadline_s: Optional[float] = None   # straggler cutoff per shard
    backoff_s: float = 0.0             # base retry backoff (exponential)
    # ---- runtime feedback (supervised catalog executor only) ----
    steal_factor: Optional[float] = None   # > 0: mid-stream work stealing
    steal_quantum: Optional[int] = None    # tiles per dispatch batch
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
    attempts: int = 1                  # supervisor rounds (1 == quiet run)
    recovered_tiles: int = 0           # tiles re-executed after a failure
    coverage: float = 1.0              # live pairs scored / planned
    steals: int = 0                    # work-stealing events (supervised)
    measured_makespan_s: float = 0.0   # supervisor busy-time makespan

    @property
    def makespan_seconds(self) -> float:
        return float(self.reducer_seconds.max()) if self.reducer_seconds.size else 0.0


def _match_pairs_chunked(feats, codes, lens, rows_a, rows_b, threshold,
                         margin, device, impl: str = "auto"
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """REFERENCE executor (``ERConfig.executor = "reference"``): filter-
    and-verify over materialized (rows_a, rows_b). Stage 1 is a paired
    f32 dot on the device, compared with the threshold on the host; stage
    2 the exact verifier on the route ``impl`` picks."""
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
                        device=device, impl=impl)


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
        with trace.span("compiler.job1") as job1:
            to_global = sn_sort_order(titles)
            plan = plan_sorted_neighborhood(n, cfg.window, cfg.r)
        bdm_seconds = job1.seconds
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
        with trace.span("compiler.job1") as job1:
            kb = block_ids[keyed_idx]
            kp = part_ids[keyed_idx]
            num_blocks = int(kb.max()) + 1 if kb.size else 0
            bdm = compute_bdm(kb, kp, num_blocks, cfg.m)
            eidx = entity_indices(kb, kp, bdm)
        bdm_seconds = job1.seconds

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


def _tile_geometry(job: MatchJob, cfg: ERConfig,
                  extra: Optional[Dict] = None) -> Tuple[int, int]:
    """Per-job tile geometry: the occupancy autotuner's pick when
    ``cfg.tune_tiles`` (recorded as ``extra["tuned_geometry"]["job<k>"]``
    in call order, as the JAX package records it), else the configured
    (block_m, block_n)."""
    if not cfg.tune_tiles:
        return cfg.block_m, cfg.block_n
    rep = autotune(job, d=cfg.feature_dim,
                   capacity=cfg.compact_capacity or 0)
    if extra is not None:
        tuned = extra.setdefault("tuned_geometry", {})
        tuned[f"job{len(tuned)}"] = rep.geometry
    return rep.geometry


def _lower_plan(plan, cfg: ERConfig,
                extra: Optional[Dict] = None) -> TileCatalog:
    job = plan_to_job(plan)
    return lower(job, *_tile_geometry(job, cfg, extra))


def compile_catalog(plan, cfg: ERConfig, extra: Optional[Dict] = None
                    ) -> Tuple[TileCatalog, Schedule]:
    """``plan_to_job → lower → schedule_tiles`` on one device: the tile
    catalog the catalog executor scores, with the scheduled reducers, and
    its schedule; the geometry is :func:`_tile_geometry`'s."""
    catalog = _lower_plan(plan, cfg, extra)
    sched = schedule_tiles(catalog, n_dev=1, policy=cfg.schedule_policy)
    return apply_schedule(catalog, sched), sched


@dataclass
class _MeshLayout:
    """How ``run_er`` lays the main job onto a mesh: the data shard count,
    the model axis (None at size 1), the zero-padded feature shape and the
    comms plan (None for flat)."""
    n_dev: int
    model_axis: Optional[str]
    rows: int
    cols: int
    comms_plan: Optional[object]


def _mesh_layout(mesh, axis: str, catalog: TileCatalog, n_rows: int,
                 n_cols: int, cfg: ERConfig, extra: Dict) -> _MeshLayout:
    """Rows pad to a multiple of shards × lcm(bm, bn) and columns to a
    multiple of the model axis (catalog tiles reference only real rows,
    and zero columns add 0 to every dot); a non-flat ``cfg.comms`` is
    planned on the padded rows, its fallback recorded in
    ``extra["comms_fallback"]``."""
    n_dev = int(mesh.shape[axis])
    n_model = (int(mesh.shape["model"])
               if "model" in mesh.axis_names and axis != "model" else 1)
    mult = n_dev * int(np.lcm(catalog.block_m, catalog.block_n))
    rows = -(-n_rows // mult) * mult
    cols = -(-n_cols // n_model) * n_model
    comms_plan = None
    if cfg.comms != "flat":
        comms_plan = plan_comms(catalog, rows, n_dev, policy=cfg.comms,
                                n_model=n_model, feature_dim=cols,
                                self_join=True)
        if comms_plan.fallback:
            extra["comms_fallback"] = comms_plan.fallback
    return _MeshLayout(n_dev=n_dev,
                       model_axis="model" if n_model > 1 else None,
                       rows=rows, cols=cols, comms_plan=comms_plan)


def run_er(titles: Sequence[str], config: Optional[ERConfig] = None,
           block_ids: Optional[np.ndarray] = None,
           fault_injector=None, feedback=None, mesh=None,
           axis: str = "data", *, device="cuda") -> ERResult:
    """Match a single source on ``device``. ``block_ids`` overrides prefix
    blocking (ignored by ``strategy="sorted_neighborhood"``).

    ``config=None`` builds a fresh default ``ERConfig`` per call; the
    resolved config is returned on ``ERResult.config``. Seconds per stage
    land on ``ERResult.extra["timings"]``, each the duration of the
    stage's span (:mod:`.trace`): ``stage1_s`` is host wall time from
    launch until the survivors are on the host (the device's own time
    is in a device trace); on the card each stage ends in a synchronize.

    With ``cfg.supervised_devices > 0`` (or a ``fault_injector``) the
    catalog executor's stage 1 runs through the fault-tolerant supervisor
    (``compiler.execute_supervised``) on that many logical device shards;
    ``ERResult.attempts`` / ``recovered_tiles`` / ``coverage`` report what
    recovery did, and the match set equals the failure-free run's.
    ``feedback`` (an ``EwmaCostModel``, supervised runs only) calibrates
    every supervised schedule and enables ``cfg.steal_factor`` work
    stealing; with ``cfg.steal_factor`` set and no model given, a fresh
    one is made for the run. ``cfg.tune_tiles`` lowers each job at the
    autotuner's geometry (``extra["tuned_geometry"]``).

    ``mesh`` (a :class:`~repro_torch.sharding.Mesh`, catalog executor
    only) runs the main job's catalog through ``compiler.execute`` on the
    mesh's devices: rows shard over ``axis``, ``cfg.comms`` picks the
    gather policy (a degraded plan's reason lands in
    ``extra["comms_fallback"]``), and a ``model`` axis of size > 1 shards
    the feature dimension with in-scorer psum combination. Features are
    zero-padded to shard- and tile-divisible sizes (padding rows are never
    referenced by catalog tiles and padding columns add 0 to every dot).
    The match_⊥ job and stage 2 run on the mesh's first device. A mesh
    names its devices, so ``device`` must have the mesh's device type.
    """
    with trace.span("pipeline.run_er") as run:
        res = _run_er(titles, config, block_ids, fault_injector, feedback,
                      mesh, axis, device)
    res.extra["timings"]["total_s"] = run.seconds
    return res


def _run_er(titles, config, block_ids, fault_injector, feedback, mesh, axis,
            device) -> ERResult:
    """The body of :func:`run_er`, inside its ``pipeline.run_er`` span;
    every timing is a span's duration."""
    n = len(titles)
    cfg = config if config is not None else ERConfig()
    if cfg.executor not in ("catalog", "reference"):
        raise ValueError(f"unknown executor {cfg.executor!r}")
    if cfg.kernel_impl not in ops.IMPLS:
        raise ValueError(f"unknown kernel_impl {cfg.kernel_impl!r}")
    supervised = cfg.supervised_devices > 0 or fault_injector is not None
    if supervised and cfg.executor != "catalog":
        raise ValueError("supervised execution requires executor='catalog'")
    if cfg.comms not in COMMS_POLICIES:
        raise ValueError(f"unknown comms policy {cfg.comms!r}")
    dev = resolve_device(device)
    if mesh is not None:
        if supervised:
            raise ValueError("supervised execution drives logical shards "
                             "host-side; it cannot also run on a mesh")
        if cfg.executor != "catalog":
            raise ValueError("mesh execution requires executor='catalog'")
        if mesh.device_type != dev.type:
            raise ValueError(f"device={device!r} is not the mesh's device "
                             f"type ({mesh.device_type})")
        dev = mesh.first_device
    if supervised and feedback is None and cfg.steal_factor is not None:
        feedback = EwmaCostModel(max(cfg.supervised_devices, 1))
    devices = [dev] + (list(mesh.devices.flat) if mesh is not None else [])

    def _sync():
        synchronize(devices)

    timings: Dict[str, float] = {}
    # On the card the features are made there; a mesh keeps the host route
    # (whatever kernel_impl says) and lays its shards out from there.
    with trace.span("encode.featurize") as sp:
        if mesh is None:
            codes, lens, feats = featurize(titles, cfg, device=dev)
        else:
            codes, lens, feats = map(torch.from_numpy, featurize(titles, cfg))
    timings["featurize_s"] = sp.seconds

    extra: Dict = {"timings": timings}

    # ---- Job 1 + plan: the ONLY strategy-aware stage ----
    with trace.span("compiler.plan_job") as planned:
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
    sup = {"attempts": 1, "recovered_tiles": 0, "planned_cost": 0,
           "scored_cost": 0, "steals": 0, "measured_makespan_s": 0.0}

    def _stage1(catalog, feats_a, feats_b=None, **on_mesh):
        """Stage 1 of a catalog: plain (on a mesh with ``on_mesh``'s
        execute arguments), or through the supervisor with its report
        folded into the run-level recovery accounting."""
        threshold = cfg.threshold - cfg.filter_margin
        if not supervised:
            return execute(catalog, feats_a, feats_b, threshold=threshold,
                           impl=cfg.kernel_impl,
                           compact_capacity=cfg.compact_capacity, device=dev,
                           **on_mesh)
        ca, cb, rep = execute_supervised(
            catalog, feats_a, feats_b, threshold=threshold,
            n_dev=max(cfg.supervised_devices, 1), impl=cfg.kernel_impl,
            policy=cfg.schedule_policy, injector=fault_injector,
            shard_deadline=cfg.shard_deadline_s,
            max_retries=cfg.max_retries, backoff=cfg.backoff_s,
            feedback=feedback, steal_factor=cfg.steal_factor,
            steal_quantum=cfg.steal_quantum,
            compact_capacity=cfg.compact_capacity, device=dev)
        sup["attempts"] = max(sup["attempts"], rep.rounds)
        for k in ("recovered_tiles", "planned_cost", "scored_cost",
                  "steals"):
            sup[k] += getattr(rep, k)
        sup["measured_makespan_s"] += rep.measured_makespan_s
        return ca, cb

    layout = None
    timings["plan_s"] = planned.seconds - bdm_seconds
    if cfg.executor == "catalog":
        with trace.span("compiler.lower") as lowered:
            catalog = _lower_plan(plan, cfg, extra)
        extra["catalog_tiles"] = catalog.num_tiles
        with trace.span("compiler.schedule") as sp:
            if mesh is not None:
                layout = _mesh_layout(mesh, axis, catalog, to_global.size,
                                      feats.shape[1], cfg, extra)
            sched = schedule_tiles(
                catalog, n_dev=layout.n_dev if layout else 1,
                policy=cfg.schedule_policy,
                comms_plan=layout.comms_plan if layout else None)
            catalog = apply_schedule(catalog, sched)
            sched_report = sched.stats()
        timings["plan_s"] += lowered.seconds + sp.seconds

    # ---- features and codes in blocked (or sorted) order, on the device
    # (on a mesh: the zero-padded features, row-sharded over its devices)
    cross = bool(cfg.match_missing_keys and null_idx is not None
                 and null_idx.size)
    with trace.span("pipeline.upload") as sp:
        rows = torch.from_numpy(to_global).to(feats.device)
        g_codes, g_lens = codes[rows].to(dev), lens[rows].to(dev)
        if layout is None:
            g_feats = feats[rows].to(dev)
        else:
            padded = feats.new_zeros((layout.rows, layout.cols))
            padded[:to_global.size, :feats.shape[1]] = feats[rows]
            g_feats = shard_rows(padded, mesh.grid(axis, layout.model_axis))
        if not cross:
            # only match_⊥ reads the input-order matrices
            codes = lens = feats = None
        _sync()
    timings["upload_s"] = sp.seconds

    # ---- Job 2: reduce-phase matching (one path for every strategy) ----
    if cfg.executor == "catalog":
        on_mesh = {} if layout is None else dict(
            mesh=mesh, axis=axis, schedule=sched,
            model_axis=layout.model_axis)
        with trace.span("stage1.score") as s1:
            ca, cb = _stage1(catalog, g_feats, **on_mesh)
        with trace.span("stage2.verify") as s2:
            ha, hb = verify_pairs(g_codes, g_lens, g_codes, g_lens, ca, cb,
                                  cfg.threshold, device=dev,
                                  impl=cfg.kernel_impl)
            _sync()
        timings["stage1_s"] = s1.seconds
        timings["stage2_s"] = s2.seconds
        extra["candidates"] = int(ca.size)
        _collect(matches, [(to_global[ha], to_global[hb])])
        if total:
            # Wall time attributed to reducers by planned load.
            reducer_seconds = ((s1.seconds + s2.seconds)
                               * reducer_pairs.astype(np.float64) / total)
    else:
        with trace.span("pipeline.reference") as ref:
            hits = []
            for k, (ra, rb) in enumerate(_reference_reducer_rows(plan,
                                                                 cfg.r)):
                if ra.size == 0:
                    continue
                t0 = time.perf_counter()
                ha, hb = _match_pairs_chunked(
                    g_feats, g_codes, g_lens, ra, rb,
                    cfg.threshold, cfg.filter_margin, dev, cfg.kernel_impl)
                reducer_seconds[k] = time.perf_counter() - t0
                hits.append((to_global[ha], to_global[hb]))
            _collect(matches, hits)
        timings["reference_s"] = ref.seconds

    # ---- match_⊥(R, R_∅): entities without blocking key vs everyone ----
    if cross:
        with trace.span("pipeline.cross") as cross_sp:
            bdm2 = TwoSourceBDM(
                bdm_r=np.full((1, 1), n, np.int64),
                bdm_s=np.full((1, 1), null_idx.size, np.int64))
            plan2 = plan_pair_range_2src(bdm2, cfg.r)
            extra["null_key_pairs"] = plan2.total_pairs
            feats_t, codes_t, lens_t = (x.to(dev) for x in (feats, codes,
                                                            lens))
            null_t = torch.from_numpy(null_idx).to(dev)
            if cfg.executor == "catalog":
                with trace.span("compiler.lower"):
                    xjob = cross_job(n, int(null_idx.size), cfg.r)
                    cross = lower(xjob, *_tile_geometry(xjob, cfg, extra))
                with trace.span("stage1.score"):
                    ca, cb = _stage1(cross, feats_t, feats_t[null_t])
                with trace.span("stage2.verify"):
                    ha, hb = verify_pairs(codes_t, lens_t, codes_t[null_t],
                                          lens_t[null_t], ca, cb,
                                          cfg.threshold, device=dev,
                                          impl=cfg.kernel_impl)
                hits = [(ha, null_idx[hb])]
            else:
                hits = []
                for k in range(cfg.r):
                    _, _, _, rr, rs = pairs_of_range_2src(plan2, k)
                    if rr.size == 0:
                        continue
                    hits.append(_match_pairs_chunked(
                        feats_t, codes_t, lens_t, rr, null_idx[rs],
                        cfg.threshold, cfg.filter_margin, dev,
                        cfg.kernel_impl))
            _collect(matches, hits)
            total += plan2.total_pairs
            _sync()
        timings["cross_s"] = cross_sp.seconds

    _sync()
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
        attempts=sup["attempts"],
        recovered_tiles=sup["recovered_tiles"],
        coverage=(sup["scored_cost"] / sup["planned_cost"]
                  if sup["planned_cost"] else 1.0),
        steals=sup["steals"],
        measured_makespan_s=sup["measured_makespan_s"],
    )

"""Incremental ER service: a resident blocked index serving match traffic.

The paper's Job-1 BDM exists so that plans are cheap deterministic
functions of a tiny matrix — which means a corpus ingested ONCE can
answer "match these new entities" without re-sharding or replanning from
scratch. :class:`ERService` keeps the corpus resident (encoded features
in the blocked layout on device, BDM host-side) and serves
``match(query_titles)`` micro-batches:

  1. **Incremental BDM** (`core/bdm.update_bdm`): query keys fold into
     the host-side matrices as a monoid update; never-seen blocks append
     zero rows (the corpus side stays untouched — zero-size blocks plan
     zero pairs).
  2. **Two-source plan** (`core/two_source.plan_pair_range_2src` /
     `plan_block_split_2src`): each batch is a balanced query-vs-corpus
     R × S job over the shared block space — Kolb et al.'s Appendix-I
     formulation, finally wired end to end.
  3. **Unified compiler** (`er/compiler`): the plan lowers through the
     same `plan_to_job → lower → execute` pipeline as the batch run_er —
     rectangular tiles, the CUDA catalog kernels on the card; exact
     stage-2 verify on survivors.
  4. **Shape buckets**: query batches pad to a small set of bucket sizes
     and catalogs pad to a fixed tile-chunk multiple. Eager PyTorch
     needs no fixed shapes, but the buckets keep the JAX package's
     ``stats`` and chunking. The port compiles only when it builds or
     loads a kernel library (`kernels/build.py`); after :meth:`warmup`
     has launched every kernel the service can reach, serving builds
     and loads nothing (`compile_counter` counts both).
  5. **Residency**: the corpus features go to the device once at ingest,
     as contiguous f32 tensors, with the corpus codes and lengths of the
     verifier; each batch uploads only its query buffer.
  6. **Sharded index** (``mesh=``, a :class:`~repro_torch.sharding.Mesh`):
     the corpus features are zero-padded and row-sharded over the mesh's
     devices at ingest, query batches are replicated, and tiles route
     tiles → reducers → devices through the compiler's cost-LPT schedule;
     the cross-mode scorer (`compiler.make_scorer`) is built once (and
     again only on an autotune re-pin). With ``ServiceConfig.comms`` =
     "ring" | "hierarchical" a second scorer, pinned at zero hops, replaces
     the flat corpus gather for keyed jobs, which plan a per-batch
     :func:`compiler.plan_comms` locality placement; jobs whose plan
     degrades run the flat scorer. The verifier's codes stay on the
     mesh's first device.

Port of ``repro.er.service`` (``device=``, default the card; with a mesh,
the mesh's device type). As in the JAX package, ``comms`` is validated
and ignored without a mesh.

Entities without blocking keys follow the paper's decomposition,
restricted to cross pairs: null-key queries × whole corpus, plus
null-key corpus entities × the keyed queries (`catalog_for_cross`;
null × null pairs live in the first job only). The
streaming ≡ batch contract — the union of served matches over any batch
split equals a one-shot ``run_er`` over corpus ++ queries restricted to
cross pairs (`pipeline.cross_restrict`) — is the service's correctness
oracle.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field as dataclasses_field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import blocked_layout, compute_bdm, entity_indices, update_bdm
from ..core.two_source import (TwoSourceBDM, plan_block_split_2src,
                               plan_pair_range_2src)
from .blocking import prefix_key
from ..device import resolve_device, synchronize
from ..kernels import build, ops
from ..sharding import Sharded, shard_rows
from .compiler import (COMMS_POLICIES, GEOMETRY_LATTICE, DeviceKilledError,
                       EwmaCostModel, GeometryCostModel,
                       NoHealthyDevicesError, SupervisedReport,
                       TransientScorerError, TuneReport, autotune, cross_job,
                       default_group, execute, execute_supervised, lower,
                       make_scorer, pad_catalog, plan_comms, plan_to_job,
                       schedule_tiles, verify_pairs)
from .compiler.faults import FaultInjector
from .compiler.ir import NCOLS
from .pipeline import featurize
from . import trace

__all__ = ["ServiceConfig", "ERService", "MatchResponse",
           "ServiceUnavailable", "compile_counter"]


_COUNTER_LOCK = threading.Lock()
_ACTIVE_COUNTERS: set = set()
_listener_registered = False


def _on_build_event(event: str, name: str) -> None:
    with _COUNTER_LOCK:
        for counter in _ACTIVE_COUNTERS:
            counter.count += 1


class compile_counter:
    """Count the port's run-time compilations inside a ``with`` block: each
    nvcc build of a kernel source and each first load of a kernel library
    (the two events of ``kernels/build.py``). A library already loaded
    emits none, so after a service warmup the steady-state count must be
    exactly zero (the guard the tests and ``chip_smoke.py`` assert).

    Thread-safe and re-entrant, as the JAX package's counter of XLA
    compilations: the listener is registered while any counter is live
    and removed when the last one exits, subscription and increments
    share one lock, and the same instance can be nested — the count
    resets only on the outermost ``__enter__``. Counters are global: a
    counter sees builds and loads triggered by *other* threads while it
    is open, which is what a steady-state ZERO assertion wants."""

    def __init__(self):
        self.count = 0
        self._depth = 0

    def __enter__(self) -> "compile_counter":
        global _listener_registered
        with _COUNTER_LOCK:
            if self._depth == 0:
                self.count = 0
            self._depth += 1
            if not _listener_registered:
                build.add_listener(_on_build_event)
                _listener_registered = True
            _ACTIVE_COUNTERS.add(self)
        return self

    def __exit__(self, *exc):
        global _listener_registered
        with _COUNTER_LOCK:
            self._depth -= 1
            if self._depth <= 0:
                _ACTIVE_COUNTERS.discard(self)
                if not _ACTIVE_COUNTERS and _listener_registered:
                    build.remove_listener(_on_build_event)
                    _listener_registered = False
        return False


class ServiceUnavailable(RuntimeError):
    """Clean service-level failure: every execution device is evicted
    (circuit breaker open) or died mid-request. Carries retry-after
    semantics — clients should back off ``retry_after_s`` seconds, by
    which time EVERY breaker cooldown will have elapsed and the next
    request will probe (and can re-admit) all evicted devices. Always
    computed from the live breaker state — there is deliberately no
    default, so no raise site can fall back to a made-up constant."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class MatchResponse(set):
    """``ERService.match``'s result: behaves exactly like the historical
    ``set`` of (corpus_index, query_index) pairs, with degradation
    metadata on the side. ``coverage`` is live pairs scored / planned —
    1.0 on the quiet path and after any full recovery; < 1.0 only when
    the service returned partial results instead of failing."""

    def __init__(self, *args):
        super().__init__(*args)
        self.attempts = 1          # max supervisor rounds over the jobs
        self.recovered_tiles = 0   # tiles recovered on retry rounds
        self.degraded = False      # True iff coverage < 1.0
        self.planned_cost = 0      # live pairs planned across jobs
        self.scored_cost = 0       # live pairs actually scored
        self.steals = 0            # work-stealing events across the jobs
        self.stolen_tiles = 0      # queued tiles moved off slow devices

    @property
    def coverage(self) -> float:
        if self.planned_cost == 0:
            return 1.0
        return self.scored_cost / self.planned_cost

    def _fold(self, report: Optional[SupervisedReport]):
        if report is None:
            return
        self.attempts = max(self.attempts, report.rounds)
        self.recovered_tiles += report.recovered_tiles
        self.planned_cost += report.planned_cost
        self.scored_cost += report.scored_cost
        self.steals += report.steals
        self.stolen_tiles += report.stolen_tiles
        if report.lost_tiles:
            self.degraded = True


@dataclass
class _RequestContext:
    """Request-scoped execution state. One instance is created at the
    OUTER ``match`` entry and threaded through every slice and job of
    that request — the deadline is armed exactly once (an oversized
    batch's k slices share one budget instead of re-arming k fresh
    ones), and supervised reports accumulate here instead of on the
    service instance (where overlapping requests from the batcher's
    threads would clobber each other). ``id`` is the ``super_batch``
    attribute of the request's spans: one ``match`` call, or one
    super-batch of :class:`~.batcher.ERBatcher`."""
    deadline_at: Optional[float] = None   # absolute perf_counter deadline
    id: int = 0
    reports: List[SupervisedReport] = dataclasses_field(
        default_factory=list)


@dataclass
class _PlannedJob:
    """One lowered stage-1 job of a planned batch: everything the
    executor needs, with no remaining dependence on mutable host state.

    ``map_a``/``map_b`` translate survivor (a, b) coordinates back to
    (corpus_index, query_index_within_batch); ``map_a`` None means the
    a-side rows already are corpus indices."""
    feats_a: object
    catalog: object
    q_buf: np.ndarray
    codes_a: object               # resident device tensor
    lens_a: object
    codes_b: np.ndarray
    lens_b: np.ndarray
    map_a: Optional[np.ndarray]
    map_b: np.ndarray
    # Resolved comms plan for this job's catalog (mesh= with
    # cfg.comms != "flat" only): locality tile placement + buffer
    # origins for the pinned ring/hierarchical scorer. None routes the
    # job through the flat-gather scorer.
    comms_plan: Optional[object] = None


@dataclass
class _PlannedBatch:
    """The host-side half of one batch: featurized queries planned,
    lowered and padded into fixed-shape jobs. Produced by
    ``ERService._plan_batch`` (under the service's host lock — it folds
    the batch into the vocab/BDM), consumed by ``_execute_batch``
    (device-side, lock-free). The split is what lets the batcher
    pipeline the next batch's planning under the current batch's
    kernels. ``t0_ns`` is the start of its ``service.plan_batch`` span
    (``time.time_ns()``)."""
    nq: int
    bucket: int
    t0_ns: int
    record: bool
    planned: int                  # live pairs planned across the jobs
    jobs: List[_PlannedJob]


@dataclass
class ServiceConfig:
    strategy: str = "pair_range"          # two-source planner: pair_range
                                          # | block_split
    r: int = 16                           # reduce tasks per query job
    m: int = 8                            # corpus input partitions (BDM cols)
    threshold: float = 0.8
    filter_margin: float = 0.25
    prefix_len: int = 3
    feature_dim: int = 256
    max_len: int = 64
    match_missing_keys: bool = True
    block_m: int = 128                    # catalog tile rows
    block_n: int = 128                    # catalog tile cols
    kernel_impl: str = "auto"             # auto | cuda | torch
    query_buckets: Tuple[int, ...] = (8, 32, 128, 512)  # batch pad sizes
    tile_chunk: int = 256                 # fixed catalog chunk (tiles/launch)
    compact_capacity: Optional[int] = None  # stage-1 packed survivor slots
                                            # per tile; None = bm·bn (the
                                            # no-overflow default)
    schedule_policy: str = "cost_lpt"     # cost_lpt | round_robin
    comms: str = "flat"                   # mesh= gather policy for keyed
                                          # jobs: flat | ring |
                                          # hierarchical. Ignored without
                                          # a mesh; jobs whose plan
                                          # degrades run the flat scorer.
    # ---- fault tolerance (DESIGN.md §Fault tolerance) ----
    exec_devices: int = 0                 # > 0: supervised stage 1 over N
                                          # logical device shards
    request_deadline_s: Optional[float] = None  # per-request wall budget
    shard_deadline_s: Optional[float] = None    # per-shard straggler cutoff
    max_retries: int = 3                  # extra recovery rounds per job
    backoff_s: float = 0.02               # base retry backoff (exponential)
    backoff_factor: float = 2.0
    partial_results: bool = True          # degrade instead of failing
    breaker_threshold: int = 3            # consecutive failures → evict
    breaker_cooldown_s: float = 0.5       # probe an evicted device after this
    # ---- runtime feedback (DESIGN.md §Scheduling feedback loop) ----
    feedback_scheduling: bool = False     # EWMA-calibrate schedule_tiles
    steal_factor: Optional[float] = None  # > 0: mid-stream work stealing
    steal_quantum: Optional[int] = None   # tiles per dispatch batch
    feedback_alpha: float = 0.35          # EWMA smoothing factor
    feedback_state: Optional[dict] = None  # export_feedback_state() of a
                                           # previous process: warm-starts
                                           # the EWMA + geometry models
    # ---- tile-geometry autotuning (DESIGN.md §Autotuning) ----
    autotune_tiles: bool = False          # warmup sweeps the lattice and
                                          # pins the winning (bm, bn)
    autotune_lattice: Tuple[Tuple[int, int], ...] = GEOMETRY_LATTICE


class ERService:
    """Resident blocked index + two-source query matcher (module docstring).

    ``match(query_titles)`` returns the set of (corpus_index,
    query_index_within_batch) pairs with verified similarity >=
    ``cfg.threshold``. The index lives on ``device`` (default the card;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels).
    Pass ``mesh=`` for the sharded-index variant (corpus row-sharded over
    ``axis``, queries replicated); ``device`` must then have the mesh's
    device type.
    """

    def __init__(self, corpus_titles: Sequence[str],
                 config: Optional[ServiceConfig] = None,
                 mesh=None, axis: str = "data", *, device="cuda"):
        self.cfg = cfg = config if config is not None else ServiceConfig()
        if cfg.strategy not in ("pair_range", "block_split"):
            raise ValueError(f"unknown strategy {cfg.strategy!r}")
        if cfg.comms not in COMMS_POLICIES:
            raise ValueError(f"unknown comms policy {cfg.comms!r}")
        if cfg.kernel_impl not in ops.IMPLS:
            raise ValueError(f"unknown kernel_impl {cfg.kernel_impl!r}; "
                             f"expected one of {ops.IMPLS}")
        if cfg.exec_devices > 0 and mesh is not None:
            raise ValueError(
                "supervised execution (exec_devices > 0) drives logical "
                "device shards host-side; it composes with mesh=None only")
        self.mesh = mesh
        self.axis = axis
        self.device = resolve_device(device)
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"device={device!r} is not the mesh's "
                                 f"device type ({mesh.device_type})")
            self.device = mesh.first_device
            self._grid = mesh.grid(axis)
        ops.resolve_impl(cfg.kernel_impl, self.device)  # "cuda" needs a card
        self._n_dev = int(mesh.shape[axis]) if mesh is not None else 1
        # Residency row multiple: shard-divisible always; with a comms
        # policy also tile-divisible at EVERY geometry the service can
        # serve (cfg.block_m plus the autotune lattice), so
        # n_loc % bm == 0 holds after any re-pin and per-batch plans
        # never degrade on alignment.
        self._row_mult = self._n_dev
        if mesh is not None and cfg.comms != "flat":
            bms = {int(cfg.block_m)}
            if cfg.autotune_tiles:
                bms |= {int(bm) for bm, _ in cfg.autotune_lattice}
            self._row_mult *= int(np.lcm.reduce(sorted(bms)))
        self._n_exec = max(cfg.exec_devices, 1)
        # ONE EWMA model for the service's lifetime: steady-state serving
        # self-tunes — every request's shard timings calibrate the next
        # request's schedule. A previous process's exported state seeds
        # it, so a restarted service schedules from measured rates
        # instead of relearning the fleet from the prior.
        seed_state = cfg.feedback_state or {}
        self.feedback: Optional[EwmaCostModel] = None
        if (cfg.feedback_scheduling or cfg.steal_factor is not None
                or "ewma" in seed_state):
            ewma = seed_state.get("ewma")
            if ewma is not None and int(ewma.get("n_dev", -1)) == self._n_exec:
                self.feedback = EwmaCostModel.from_state(ewma)
            else:
                # No snapshot, or one from a different fleet topology —
                # rates keyed to other devices would mis-calibrate.
                self.feedback = EwmaCostModel(self._n_exec,
                                              alpha=cfg.feedback_alpha)
        self.geometry_feedback = (
            GeometryCostModel.from_state(seed_state["geometry"])
            if "geometry" in seed_state
            else GeometryCostModel(alpha=cfg.feedback_alpha))
        self.tune_report: Optional[TuneReport] = None
        self.fault_injector: Optional[FaultInjector] = None
        self._gathered: Dict[int, tuple] = {}   # id -> (sharded, gathered)
        self._fail_streak = np.zeros(self._n_exec, np.int64)
        self._breaker_open: Dict[int, float] = {}   # device → eviction time
        # Serializes mutation of host-side shared state (vocab, BDMs,
        # stats, breaker) so overlapping requests — the batcher's planner
        # runs concurrently with its executor — stay correct. Request-
        # scoped state (deadline, reports) lives on _RequestContext, NOT
        # here: an instance field would be clobbered across threads.
        self._host_lock = threading.RLock()
        self._ctx_ids = itertools.count(1)
        self._buckets = tuple(sorted(cfg.query_buckets))
        if not self._buckets:
            raise ValueError("query_buckets must be non-empty")
        self._stage1 = cfg.threshold - cfg.filter_margin
        self._titles: List[str] = list(corpus_titles)
        self.n_corpus = n = len(self._titles)

        t0 = time.perf_counter()
        block_ids = np.empty(n, np.int64)
        self._vocab: Dict[str, int] = {}
        for i, t in enumerate(self._titles):  # mirrors prefix_block_ids
            block_ids[i] = self._key_id(t)
        part_ids = np.minimum(
            np.arange(n, dtype=np.int64) * cfg.m // max(n, 1), cfg.m - 1)
        keyed_idx = np.flatnonzero(block_ids >= 0)
        self._null_idx = np.flatnonzero(block_ids < 0)

        # Bulk ingest featurizes on the card (a mesh keeps the host route,
        # whatever kernel_impl says, and shards from there); per-batch
        # queries stay on the host (``_plan_jobs``).
        if mesh is None:
            codes, lens, feats = featurize(self._titles, cfg,
                                           device=self.device)
        else:
            codes, lens, feats = map(torch.from_numpy,
                                     featurize(self._titles, cfg))

        # ---- Job 1 once: BDM + blocked layout, then stay resident ----
        kb, kp = block_ids[keyed_idx], part_ids[keyed_idx]
        self._bdm = compute_bdm(kb, kp, len(self._vocab), cfg.m)
        eidx = entity_indices(kb, kp, self._bdm)
        perm, _ = blocked_layout(kb, eidx, self._bdm.sum(axis=1))
        self._to_global = keyed_idx[perm]

        # Resident device-side matrices, one set per job kind: the
        # filter features (f32; sharded over a mesh) and the verifier's
        # codes and lengths, gathered where they were featurized.
        keyed = torch.from_numpy(self._to_global).to(feats.device)
        null = torch.from_numpy(self._null_idx).to(feats.device)
        self._feats_keyed = self._resident_feats(feats[keyed])
        self._feats_all = self._resident_feats(feats)
        self._feats_null = self._resident_feats(feats[null])
        self._k_codes = self._resident(codes[keyed])
        self._k_lens = self._resident(lens[keyed])
        self._codes = self._resident(codes)
        self._lens = self._resident(lens)
        self._n_codes = self._resident(codes[null])
        self._n_lens = self._resident(lens[null])
        self._sync()
        self.ingest_seconds = time.perf_counter() - t0

        # Cumulative query-side BDM (1 traffic partition) — the running
        # skew statistics a re-balancer would replan from.
        self._traffic_bdm = np.zeros((len(self._vocab), 1), np.int64)
        self.stats: Dict = {"batches": 0, "queries": 0, "planned_pairs": 0,
                            "matches": 0, "seconds": 0.0,
                            "bucket_hits": {b: 0 for b in self._buckets},
                            "retries": 0, "recovered_tiles": 0,
                            "degraded": 0, "breaker_evictions": 0,
                            "breaker_readmissions": 0,
                            "steals": 0, "stolen_tiles": 0}

        # The served tile geometry: cfg.block_m/n until the autotuning
        # warmup pins a lattice winner.
        self._block_m = cfg.block_m
        self._block_n = cfg.block_n
        self._dist_scorer = None
        self._comms_scorer = None
        self._pin_group = (default_group(self._n_dev)
                           if cfg.comms == "hierarchical" else 1)
        self._build_dist_scorer()

    def _sync(self):
        synchronize(self.mesh.devices.flat if self.mesh is not None
                    else [self.device])

    def _build_dist_scorer(self):
        """(Re)build the mesh cross-mode scorer at the current pinned
        geometry: ONE scorer per geometry for the service's lifetime,
        built at construction and on an autotune re-pin (during warmup
        only). Compact (packed-slot decode, no host mask scan)."""
        if self.mesh is None:
            return
        cfg = self.cfg
        kw = dict(mode="cross", threshold=self._stage1,
                  block_m=self._block_m, block_n=self._block_n,
                  impl=cfg.kernel_impl, compact=True,
                  capacity=cfg.compact_capacity)
        self._dist_scorer = make_scorer(self.mesh, self.axis, **kw)
        if cfg.comms != "flat":
            # The pinned comms scorer. For cross-mode jobs ZERO hops is
            # exact, not a guess: every catalog tile's a-rows sit inside
            # one bm-aligned block, and residency padding keeps n_loc a
            # multiple of every served bm, so a locality-placed tile never
            # reads outside its own strip. Ring therefore gathers
            # nothing; hierarchical still assembles its group panel
            # (g − 1 intra hops) with zero inter-group hops. Plans whose
            # alignment gates fail degrade to the flat scorer above.
            self._comms_scorer = make_scorer(
                self.mesh, self.axis, comms=cfg.comms, hops=0,
                group=self._pin_group, inter_hops=0, **kw)

    def _set_geometry(self, block_m: int, block_n: int):
        """Pin a served tile geometry (autotune warmup only)."""
        if (block_m, block_n) == (self._block_m, self._block_n):
            return
        self._block_m = int(block_m)
        self._block_n = int(block_n)
        self._build_dist_scorer()

    @property
    def tile_geometry(self) -> Tuple[int, int]:
        """The (block_m, block_n) the service currently serves at."""
        return (self._block_m, self._block_n)

    # ------------------------------------------------------------------
    # Blocking-key vocabulary (persistent across corpus and all batches)
    # ------------------------------------------------------------------

    def _key_id(self, title: str) -> int:
        key = prefix_key(title, self.cfg.prefix_len)  # THE batch key rule
        if key is None:
            return -1
        if key not in self._vocab:
            self._vocab[key] = len(self._vocab)
        return self._vocab[key]

    def _query_block_ids(self, titles: Sequence[str],
                         record: bool = True) -> np.ndarray:
        ids = np.asarray([self._key_id(t) for t in titles], np.int64)
        b_now = len(self._vocab)
        if b_now > self._bdm.shape[0]:
            # Never-seen blocks: grow the resident corpus BDM with zero
            # rows (appended, so the blocked layout is untouched).
            self._bdm = update_bdm(self._bdm, np.zeros(0, np.int64),
                                   np.zeros(0, np.int64), num_blocks=b_now)
        # Warmup's synthetic batches (record=False) must not skew the
        # served-traffic profile — grow the matrix, fold no counts.
        keyed = ids[ids >= 0] if record else np.zeros(0, np.int64)
        self._traffic_bdm = update_bdm(
            self._traffic_bdm, keyed, np.zeros(keyed.size, np.int64),
            num_blocks=b_now)
        return ids

    # ------------------------------------------------------------------
    # Residency and fixed-shape scoring
    # ------------------------------------------------------------------

    def _resident(self, x: torch.Tensor):
        """A matrix on the service's device, contiguous (features f32,
        codes and lengths as they are). Empty matrices stay None (their
        job is skipped)."""
        if x.shape[0] == 0:
            return None
        return x.to(self.device).contiguous()

    def _resident_feats(self, feats: torch.Tensor):
        """A feature matrix on the device, or on a mesh zero-padded to the
        residency row multiple and row-sharded over its devices (tiles'
        validity windows never reach the padding). Empty matrices stay
        None."""
        if self.mesh is None or feats.shape[0] == 0:
            return self._resident(feats)
        pad = (-feats.shape[0]) % self._row_mult
        if pad:
            feats = torch.cat([feats, feats.new_zeros((pad, feats.shape[1]))])
        return shard_rows(feats, self._grid)

    def _bucket(self, nq: int) -> int:
        for b in self._buckets:
            if b >= nq:
                return b
        raise AssertionError("oversized batches are split before bucketing")

    def _bucket_buffer(self, feats: np.ndarray, bucket: int) -> np.ndarray:
        buf = np.zeros((bucket, self.cfg.feature_dim), np.float32)
        buf[:feats.shape[0]] = feats
        return buf

    def _score(self, feats_a, catalog, q_buf: np.ndarray,
               ctx: _RequestContext, comms_plan=None):
        """Stage 1 with fixed shapes: the catalog is pre-padded to a
        tile_chunk multiple (all-zero rows, which keep nothing), the query
        buffer to a bucket size; the buffer is uploaded here, once per
        job. On a mesh, tiles route to devices through the compiler's
        cost-LPT schedule, every device shard pads to ``tile_chunk``
        tiles, and a resolved ``comms_plan`` swaps in its locality
        placement and the pinned ring/hierarchical scorer. With
        supervision enabled (``cfg.exec_devices`` or an installed fault
        injector), stage 1 runs through :func:`execute_supervised`
        instead — per-shard completion records, tile-granular recovery,
        graceful degradation; on a mesh it scores the corpus features
        gathered onto ``self.device``, as the JAX package's supervisor
        scores its sharded array."""
        cfg = self.cfg
        catalog = pad_catalog(catalog, cfg.tile_chunk)
        if self._use_supervisor:
            q = torch.from_numpy(q_buf).to(self.device)
            return self._score_supervised(self._on_device(feats_a), catalog,
                                          q, ctx)
        if self.mesh is not None:
            use_comms = (comms_plan is not None
                         and comms_plan.policy != "flat"
                         and self._comms_scorer is not None)
            plan = comms_plan if use_comms else None
            sched = schedule_tiles(catalog, n_dev=self._n_dev,
                                   policy=cfg.schedule_policy,
                                   comms_plan=plan)
            return execute(
                catalog, feats_a, q_buf, threshold=self._stage1,
                impl=cfg.kernel_impl, mesh=self.mesh, axis=self.axis,
                schedule=sched,
                scorer=self._comms_scorer if use_comms else self._dist_scorer,
                comms_plan=plan, chunk_tiles=cfg.tile_chunk,
                fixed_chunks=True, compact_capacity=cfg.compact_capacity)
        q = torch.from_numpy(q_buf).to(self.device)
        return execute(
            catalog, feats_a, q, threshold=self._stage1,
            impl=cfg.kernel_impl, chunk_tiles=cfg.tile_chunk,
            compact_capacity=cfg.compact_capacity, device=self.device)

    # ------------------------------------------------------------------
    # Fault-tolerant execution: supervisor + circuit breaker
    # ------------------------------------------------------------------

    @property
    def _use_supervisor(self) -> bool:
        return self.cfg.exec_devices > 0 or self.fault_injector is not None

    def set_fault_injector(self, injector: Optional[FaultInjector]):
        """Install (or clear) a chaos :class:`FaultInjector` — every
        supervised shard call and breaker probe flows through it. Install
        AFTER :meth:`warmup` so warmup traffic doesn't consume script
        events. On a sharded-index service (``mesh=``) the supervisor
        drives ``max(cfg.exec_devices, 1)`` logical shards of the mesh's
        first device, over the gathered corpus features (gathered once,
        on first use, and dropped when the injector is cleared)."""
        self.fault_injector = injector
        if injector is None:
            self._gathered.clear()

    def _on_device(self, feats):
        """``feats`` on ``self.device``: a row-sharded corpus matrix is
        gathered by :meth:`_gather` on its first use and kept."""
        if not isinstance(feats, Sharded):
            return feats
        hit = self._gathered.get(id(feats))
        if hit is None:
            hit = self._gathered[id(feats)] = (feats, self._gather(feats))
        return hit[1]

    def _gather(self, feats: Sharded) -> torch.Tensor:
        """A row-sharded matrix on ``self.device``: row blocks in order,
        column blocks side by side."""
        return torch.cat([torch.cat([b.to(self.device) for b in row], dim=1)
                          for row in feats.blocks], dim=0)

    def _exec_mask(self) -> np.ndarray:
        """Healthy mask over the logical execution devices: everything
        minus the breaker-evicted set."""
        mask = np.ones(self._n_exec, bool)
        for d in self._breaker_open:
            mask[d] = False
        return mask

    def _probe_evicted(self):
        """Re-admission path: once an evicted device's cooldown elapses,
        probe it (one injector shard call — a trivially cheap health RPC
        in a real deployment). Probe success re-admits the device and
        resets its failure streak; failure restarts the cooldown."""
        with self._host_lock:
            now = time.monotonic()
            for d, opened in list(self._breaker_open.items()):
                if now - opened < self.cfg.breaker_cooldown_s:
                    continue
                ok = True
                if self.fault_injector is not None:
                    try:
                        self.fault_injector.shard_call(d)
                    except (DeviceKilledError, TransientScorerError):
                        ok = False
                if ok:
                    del self._breaker_open[d]
                    self._fail_streak[d] = 0
                    if self.feedback is not None:
                        # The EWMA rates this device accumulated while it
                        # straggled describe the device that got EVICTED,
                        # not the one that just passed a health probe —
                        # keeping them would under-schedule the recovered
                        # device indefinitely. Forget them; the next
                        # accepted shard call re-calibrates from the
                        # global rate.
                        self.feedback.reset_device(d)
                    self.stats["breaker_readmissions"] += 1
                else:
                    self._breaker_open[d] = now

    def _update_breaker(self, report: SupervisedReport):
        """Fold a job's shard records into the per-device failure
        streaks; devices at ``breaker_threshold`` consecutive failures
        are evicted until a probe succeeds."""
        with self._host_lock:
            now = time.monotonic()
            for rec in report.records:
                if rec.status == "ok":
                    self._fail_streak[rec.device] = 0
                else:
                    self._fail_streak[rec.device] += 1
                    if (self._fail_streak[rec.device]
                            >= self.cfg.breaker_threshold
                            and rec.device not in self._breaker_open):
                        self._breaker_open[rec.device] = now
                        self.stats["breaker_evictions"] += 1

    def _retry_after(self) -> float:
        """Seconds until the LAST evicted device becomes probeable — a
        client that waits this long is guaranteed the next request
        probes every evicted device, instead of racing the longest
        cooldown and landing back here. Clamped to the cooldown span
        (the remaining time can never legitimately exceed it)."""
        if not self._breaker_open:
            return max(self.cfg.backoff_s, 1e-3)
        now = time.monotonic()
        rem = max(self.cfg.breaker_cooldown_s - (now - t)
                  for t in self._breaker_open.values())
        return min(max(rem, 1e-3), max(self.cfg.breaker_cooldown_s, 1e-3))

    def _score_supervised(self, feats_a, catalog, q_buf,
                          ctx: _RequestContext):
        """Stage 1 through the fault-tolerant supervisor on
        ``cfg.exec_devices`` logical shards. Collects the report on the
        request context for the coverage aggregation and feeds the
        breaker. The wall budget is whatever remains of the REQUEST's
        deadline — armed once at the outer ``match`` entry, so an
        oversized request's later slices see a shrinking budget instead
        of each re-arming a fresh one."""
        cfg = self.cfg
        self._probe_evicted()
        healthy = self._exec_mask()
        if not healthy.any():
            raise ServiceUnavailable(
                "all execution devices are circuit-broken",
                retry_after_s=self._retry_after())
        remaining = None
        if ctx.deadline_at is not None:
            remaining = max(ctx.deadline_at - time.perf_counter(), 0.0)
        try:
            ra, rb, report = execute_supervised(
                catalog, feats_a, q_buf,
                threshold=self._stage1, n_dev=self._n_exec,
                healthy=healthy, impl=cfg.kernel_impl,
                chunk_tiles=cfg.tile_chunk, policy=cfg.schedule_policy,
                injector=self.fault_injector,
                shard_deadline=cfg.shard_deadline_s, deadline=remaining,
                max_retries=cfg.max_retries, backoff=cfg.backoff_s,
                backoff_factor=cfg.backoff_factor,
                partial=cfg.partial_results, feedback=self.feedback,
                steal_factor=cfg.steal_factor,
                steal_quantum=cfg.steal_quantum,
                compact_capacity=cfg.compact_capacity, device=self.device)
        except NoHealthyDevicesError as e:
            # Only reachable with partial_results=False: every device
            # died mid-job. Surface retry-after instead of a traceback.
            raise ServiceUnavailable(
                str(e), retry_after_s=self._retry_after()) from e
        self._update_breaker(report)
        ctx.reports.append(report)
        return ra, rb

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------

    def _new_request_ctx(self) -> _RequestContext:
        """Arm one request's deadline (ONCE — slices share the budget)
        and its report accumulator."""
        deadline_at = (time.perf_counter() + self.cfg.request_deadline_s
                       if self.cfg.request_deadline_s is not None
                       else None)
        return _RequestContext(deadline_at=deadline_at,
                               id=next(self._ctx_ids))

    def match(self, query_titles: Sequence[str],
              _record: bool = True) -> "MatchResponse":
        """Match a query micro-batch against the resident corpus.

        Returns a :class:`MatchResponse` — a set of (corpus_index,
        query_index_within_batch) pairs with exact verified similarity
        >= cfg.threshold, by construction equal to a one-shot
        ``run_er(corpus ++ batch)`` restricted to cross pairs — plus
        degradation metadata (``coverage``, ``attempts``,
        ``recovered_tiles``, ``degraded``). Batches larger than the top
        bucket are served in top-bucket slices.

        With supervision enabled, a per-request deadline
        (``cfg.request_deadline_s``) bounds recovery — armed once for
        the whole request, so an oversized batch's slices spend ONE
        shared budget; on exhaustion the response carries the survivors
        found so far with ``coverage < 1`` (``cfg.partial_results``)
        instead of failing. :class:`ServiceUnavailable` (with
        ``retry_after_s``) is raised only when every execution device is
        circuit-broken.

        Thread-safe: concurrent calls see exactly the sequential match
        sets (request state is per-call, host-side index mutation is
        locked). For throughput under concurrency use
        :class:`~.batcher.ERBatcher`, which coalesces submitters into
        super-batches instead of serializing them.
        """
        query_titles = list(query_titles)
        nq = len(query_titles)
        if nq == 0 or self.n_corpus == 0:
            return MatchResponse()
        ctx = self._new_request_ctx()
        cap = self._buckets[-1]
        if nq <= cap:
            return self._match_slice(query_titles, ctx, _record)
        out = MatchResponse()
        for lo in range(0, nq, cap):
            part = self._match_slice(query_titles[lo:lo + cap], ctx,
                                     _record)
            for a, b in part:
                out.add((a, b + lo))
            out.attempts = max(out.attempts, part.attempts)
            out.recovered_tiles += part.recovered_tiles
            out.planned_cost += part.planned_cost
            out.scored_cost += part.scored_cost
            out.steals += part.steals
            out.stolen_tiles += part.stolen_tiles
            out.degraded = out.degraded or part.degraded
        return out

    def _match_slice(self, titles: List[str], ctx: _RequestContext,
                     record: bool) -> "MatchResponse":
        return self._execute_batch(self._plan_batch(titles, ctx, record),
                                   ctx)

    def _plan_batch(self, titles: List[str], ctx: _RequestContext,
                    record: bool = True) -> _PlannedBatch:
        """Host-side half of one ≤ top-bucket batch: featurize, fold the
        batch into the vocab/BDM, plan and lower every job to padded
        fixed-shape catalogs. Everything that touches mutable service
        state happens here under the host lock; the returned
        :class:`_PlannedBatch` is self-contained, so ``_execute_batch``
        can run it on another thread while the next batch plans. Its
        span is ``service.plan_batch``."""
        with trace.span("service.plan_batch", super_batch=ctx.id) as sp:
            return self._plan_jobs(titles, record, sp.start_ns)

    def _plan_jobs(self, titles: List[str], record: bool,
                   t0_ns: int) -> _PlannedBatch:
        """The body of :meth:`_plan_batch`, inside its span."""
        cfg = self.cfg
        nq = len(titles)
        bucket = self._bucket(nq)
        with trace.span("encode.featurize"):
            codes, lens, feats = featurize(titles, cfg)
        jobs: List[_PlannedJob] = []
        planned = 0
        with self._host_lock:
            qb = self._query_block_ids(titles, record=record)

            # ---- keyed queries × same-block corpus (two-source R×S) ----
            keyed_q = np.flatnonzero(qb >= 0)
            if keyed_q.size and self._feats_keyed is not None:
                qkb = qb[keyed_q]
                order = np.argsort(qkb, kind="stable")
                q_rows = keyed_q[order]        # blocked S layout → batch idx
                bdm_s = np.bincount(
                    qkb,
                    minlength=self._bdm.shape[0]).astype(np.int64)[:, None]
                bdm2 = TwoSourceBDM(bdm_r=self._bdm, bdm_s=bdm_s)
                planner = (plan_block_split_2src
                           if cfg.strategy == "block_split"
                           else plan_pair_range_2src)
                with trace.span("compiler.plan"):
                    plan = planner(bdm2, cfg.r)
                planned += plan.total_pairs
                with trace.span("compiler.lower"):
                    cat = lower(plan_to_job(plan), self._block_m,
                                self._block_n)
                cplan = None
                if self._comms_scorer is not None:
                    # Plan on the chunk-padded catalog so the locality
                    # placement covers every tile the executor sees
                    # (pad_catalog in _score is then a no-op). Pinned at
                    # zero hops — see _build_dist_scorer; a degraded plan
                    # routes the job to the flat scorer.
                    cat = pad_catalog(cat, cfg.tile_chunk)
                    cplan = plan_comms(
                        cat, int(self._feats_keyed.shape[0]), self._n_dev,
                        policy=cfg.comms, feature_dim=cfg.feature_dim,
                        self_join=False,
                        group=(self._pin_group
                               if cfg.comms == "hierarchical" else None),
                        pin_hops=0, pin_inter_hops=0)
                jobs.append(_PlannedJob(
                    feats_a=self._feats_keyed,
                    catalog=cat,
                    q_buf=self._bucket_buffer(feats[q_rows], bucket),
                    codes_a=self._k_codes, lens_a=self._k_lens,
                    codes_b=codes[q_rows], lens_b=lens[q_rows],
                    map_a=self._to_global, map_b=q_rows,
                    comms_plan=cplan))

            # ---- match_⊥, cross-restricted: null queries × corpus ----
            null_q = np.flatnonzero(qb < 0)
            if cfg.match_missing_keys and null_q.size:
                with trace.span("compiler.lower"):
                    cat = lower(cross_job(self.n_corpus, int(null_q.size),
                                          cfg.r),
                                self._block_m, self._block_n)
                planned += cat.total_pairs
                jobs.append(_PlannedJob(
                    feats_a=self._feats_all, catalog=cat,
                    q_buf=self._bucket_buffer(feats[null_q], bucket),
                    codes_a=self._codes, lens_a=self._lens,
                    codes_b=codes[null_q], lens_b=lens[null_q],
                    map_a=None, map_b=null_q))

            # ---- ... and null-key corpus entities × the keyed queries
            # (match_⊥(R0, S−S0): null × null pairs are already covered
            # by the null-query job above) ----
            if cfg.match_missing_keys and self._feats_null is not None \
                    and keyed_q.size:
                with trace.span("compiler.lower"):
                    cat = lower(cross_job(int(self._null_idx.size),
                                          int(keyed_q.size), cfg.r),
                                self._block_m, self._block_n)
                planned += cat.total_pairs
                jobs.append(_PlannedJob(
                    feats_a=self._feats_null, catalog=cat,
                    q_buf=self._bucket_buffer(feats[keyed_q], bucket),
                    codes_a=self._n_codes, lens_a=self._n_lens,
                    codes_b=codes[keyed_q], lens_b=lens[keyed_q],
                    map_a=self._null_idx, map_b=keyed_q))
        return _PlannedBatch(nq=nq, bucket=bucket, t0_ns=t0_ns,
                             record=record, planned=int(planned), jobs=jobs)

    def _execute_batch(self, pb: _PlannedBatch,
                       ctx: _RequestContext) -> "MatchResponse":
        """Device-side half: run each planned job's stage 1 + exact
        stage 2, demap survivors to (corpus_index, batch_index). Holds
        no host lock while kernels run — the batcher overlaps the next
        batch's ``_plan_batch`` with this. Its span is
        ``service.execute_batch``; ``stats["seconds"]`` adds the time
        from the plan span's start to this span's end."""
        with trace.span("service.execute_batch", super_batch=ctx.id) as sp:
            matches = self._run_jobs(pb, ctx)
        if pb.record:
            with self._host_lock:
                s = self.stats
                s["batches"] += 1
                s["queries"] += pb.nq
                s["planned_pairs"] += pb.planned
                s["matches"] += len(matches)
                s["seconds"] += (sp.end_ns - pb.t0_ns) * 1e-9
                s["bucket_hits"][pb.bucket] += 1
                s["retries"] += max(matches.attempts - 1, 0)
                s["recovered_tiles"] += matches.recovered_tiles
                s["degraded"] += int(matches.degraded)
                s["steals"] += matches.steals
                s["stolen_tiles"] += matches.stolen_tiles
        return matches

    def _run_jobs(self, pb: _PlannedBatch,
                  ctx: _RequestContext) -> "MatchResponse":
        """The body of :meth:`_execute_batch`, inside its span: per job
        ``stage1.score``, ``stage2.verify`` and ``service.demap``."""
        cfg = self.cfg
        matches = MatchResponse()
        n_reports = len(ctx.reports)
        for job in pb.jobs:
            with trace.span("stage1.score"):
                ca, cb = self._score(job.feats_a, job.catalog, job.q_buf,
                                     ctx, comms_plan=job.comms_plan)
            with trace.span("stage2.verify"):
                ha, hb = verify_pairs(job.codes_a, job.lens_a,
                                      job.codes_b, job.lens_b, ca, cb,
                                      cfg.threshold, device=self.device,
                                      impl=cfg.kernel_impl)
            with trace.span("service.demap"):
                if job.map_a is None:
                    matches.update(
                        (int(a), int(job.map_b[b])) for a, b in zip(ha, hb))
                else:
                    matches.update(
                        (int(job.map_a[a]), int(job.map_b[b]))
                        for a, b in zip(ha, hb))
        for report in ctx.reports[n_reports:]:
            matches._fold(report)
        return matches

    def warmup(self) -> int:
        """Build, load and launch everything steady-state serving can
        reach before traffic arrives: serve one synthetic batch per
        bucket, built from recycled corpus titles (guaranteed stage-1
        survivors, so the stage-2 verifier runs too) with one empty title
        appended to hit the null-key cross jobs, then launch the
        dense-mask kernel (the overflow fallback) once at the pinned
        geometry. Warmup batches are excluded from ``stats``; call it on
        the thread that owns the service, before an :class:`ERBatcher`
        starts its threads.

        With ``cfg.autotune_tiles`` the top-bucket batch first sweeps the
        geometry lattice (each candidate measured once into the geometry
        EWMA) and pins the winner; every bucket then warms at the pinned
        geometry. A restarted service whose ``cfg.feedback_state``
        already carries measured lattice rates skips the sweep and pins
        directly."""
        if self.n_corpus == 0:
            return 0
        if ops.resolve_impl(self.cfg.kernel_impl, self.device) == "cuda":
            # Build (side by side) and load here, on the caller's thread,
            # so neither the autotune sweep's first leg nor a batcher thread
            # pays for it: stage 1's kernels and stage 2's verifier.
            build.build_all(["pair_sim", "edit_distance"])
            build.load("pair_sim")
            build.load("edit_distance")
        reps = -(-self._buckets[-1] // self.n_corpus)
        pool = self._titles * reps
        if self.cfg.autotune_tiles:
            self._autotune_warmup(pool)
        for bucket in self._buckets:
            qs = pool[:bucket]
            if self.cfg.match_missing_keys and qs:
                qs = qs[:-1] + [""]
            self.match(qs, _record=False)
        feats = next(f for f in (self._feats_keyed, self._feats_all)
                     if f is not None)
        if isinstance(feats, Sharded):
            feats = feats.blocks[0][0]
        ops.pair_scores_catalog(
            feats, feats,
            torch.zeros((1, NCOLS), dtype=torch.int32, device=feats.device),
            threshold=self._stage1, block_m=self._block_m,
            block_n=self._block_n, impl=self.cfg.kernel_impl)
        self._sync()
        return len(self._buckets)

    def _tune_job(self, titles: List[str]):
        """The keyed two-source MatchJob a batch of ``titles`` would
        plan — the representative job the autotuner scores. Mirrors the
        keyed branch of :meth:`_plan_batch` without lowering."""
        cfg = self.cfg
        with self._host_lock:
            qb = self._query_block_ids(titles, record=False)
        keyed = qb[qb >= 0]
        if keyed.size == 0:
            return None
        bdm_s = np.bincount(
            keyed, minlength=self._bdm.shape[0]).astype(np.int64)[:, None]
        bdm2 = TwoSourceBDM(bdm_r=self._bdm, bdm_s=bdm_s)
        planner = (plan_block_split_2src if cfg.strategy == "block_split"
                   else plan_pair_range_2src)
        return plan_to_job(planner(bdm2, cfg.r))

    def _autotune_warmup(self, pool: List[str]):
        """Sweep the lattice on the top-bucket synthetic batch, fold each
        candidate's wall time into the geometry EWMA, pin the winner.
        Skips straight to pinning when the seeded geometry model already
        measured a lattice candidate (restart warm start)."""
        cfg = self.cfg
        qs = pool[:self._buckets[-1]]
        job = self._tune_job(qs)
        if job is None or job.total_pairs == 0:
            return
        kwargs = dict(lattice=cfg.autotune_lattice, d=cfg.feature_dim,
                      capacity=cfg.compact_capacity or 0,
                      feedback=self.geometry_feedback)
        if self.geometry_feedback.best(cfg.autotune_lattice) is None:
            report = autotune(job, **kwargs)
            for score in report.scores:
                self._set_geometry(score.block_m, score.block_n)
                t0 = time.perf_counter()
                self.match(qs, _record=False)
                # live_pairs: the keyed job's exact planned pairs — the
                # geometry-invariant denominator that makes measured
                # rates directly comparable across candidates.
                self.geometry_feedback.observe(
                    score.geometry, max(job.total_pairs, 1),
                    time.perf_counter() - t0)
        self.tune_report = autotune(job, **kwargs)
        self._set_geometry(self.tune_report.block_m,
                           self.tune_report.block_n)

    def export_feedback_state(self) -> dict:
        """Snapshot every learned model (device/class EWMA rates, the
        geometry EWMA, the pinned geometry) as one JSON-able dict. Hand
        it to a new process as ``ServiceConfig.feedback_state`` and the
        restarted service schedules — and autotunes — from measurements
        instead of cold priors."""
        state: Dict = {"geometry_pinned": [self._block_m, self._block_n]}
        if self.feedback is not None:
            state["ewma"] = self.feedback.to_state()
        state["geometry"] = self.geometry_feedback.to_state()
        return state

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    @property
    def bdm(self) -> np.ndarray:
        """Host-side corpus BDM (b × m) — grows rows as queries reveal
        never-seen blocks."""
        return self._bdm

    @property
    def traffic_bdm(self) -> np.ndarray:
        """Cumulative query-side block counts (b × 1): the skew profile
        of served traffic, folded in with :func:`core.bdm.update_bdm`."""
        return self._traffic_bdm

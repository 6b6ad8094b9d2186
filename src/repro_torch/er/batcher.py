"""Async super-batching front-end for :class:`~.service.ERService`.

Port of ``repro.er.batcher``, unchanged in design: a planner thread and
an executor thread. The executor thread launches the CUDA kernels on its
own current stream (the launchers set the device themselves), and the
kernel library is built and loaded under a lock, once; call
``service.warmup()`` before the batcher starts so neither thread builds.

``ERService.match`` is synchronous: one caller, one micro-batch, one
pass through the bucket contract. Under concurrent traffic that leaves
the balanced schedules idle between micro-batches — the serving
throughput problem dynamic batching solves for model servers applies
unchanged here. :class:`ERBatcher` closes the gap:

  * **Super-batching.** ``submit(query_titles)`` returns a
    ``concurrent.futures.Future`` immediately; concurrent submissions
    accumulate into ONE super-batch that flushes when it reaches
    ``max_batch`` queries (flush-on-full) or when the oldest pending
    request has waited ``max_delay_s`` (flush-on-deadline). The
    super-batch pads to the same shape buckets sequential traffic uses,
    and steady state builds and loads no kernel library.
  * **Exact demultiplexing.** A super-batch is the concatenation of its
    member requests, and the service's streaming ≡ batch contract says
    the match set of a concatenation equals the union over any split —
    so slicing each member's pairs back out by query offset yields
    EXACTLY what a sequential ``match`` would have returned. Response
    metadata (coverage, attempts, steals) is shared-fate: every member
    reports the super-batch it rode in.
  * **Plan/execute pipeline.** Planning (featurize + fold into the
    BDM + lower to catalogs, host-side, under the service's host lock)
    and execution (kernel launches) run on separate threads connected
    by a depth-1 queue — a two-deep pipeline in which super-batch k+1
    plans while super-batch k's kernels are in flight. Spans
    (:mod:`.trace`) time the waits: ``batcher.queue`` from ``submit``
    until the planner takes the request into a super-batch,
    ``batcher.handoff`` while the planner blocks on the queue,
    ``batcher.await_plan`` while the executor waits for a plan, and
    ``batcher.demux`` while it hands the answers to the requests.
  * **Per-tenant admission.** A token bucket per tenant id (refill
    ``tenant_rate`` queries/s, burst ``tenant_burst``) rejects the
    excess of a hot tenant with :class:`AdmissionError` (carrying
    ``retry_after_s``) instead of letting it starve the shared bucket.

The batcher requires the service refactor that made requests
thread-safe: request state lives on a per-request context, host-side
index mutation is locked, and the request deadline is armed once per
request (so a super-batch spends one shared budget).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import trace
from .service import ERService, MatchResponse

__all__ = ["ERBatcher", "AdmissionError"]


class AdmissionError(RuntimeError):
    """A tenant's token bucket cannot cover the submitted queries.
    Clients should back off ``retry_after_s`` seconds — the bucket will
    have refilled enough for this request by then (requests larger than
    the burst can never be admitted whole; split them)."""

    def __init__(self, msg: str, retry_after_s: float, tenant: str):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)
        self.tenant = tenant


class _TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill toward ``burst``.
    Not thread-safe on its own — the batcher serializes access."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t = time.monotonic()

    def try_take(self, n: int) -> float:
        """Take ``n`` tokens; returns 0.0 on success, else the seconds
        until the bucket will hold ``n`` (capped at the burst)."""
        now = time.monotonic()
        self.tokens = min(self.burst, self.tokens + (now - self.t) * self.rate)
        self.t = now
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        need = min(float(n), self.burst) - self.tokens
        return max(need / self.rate, 1e-3)


@dataclass
class _Pending:
    titles: List[str]
    nq: int
    tenant: str
    future: Future
    arrived: float
    queued: object                 # its batcher.queue span (trace.start)


@dataclass
class _Super:
    """One assembled super-batch: member requests with their offsets
    into the concatenated query list, plus the shared request context
    (one deadline for the whole super-batch)."""
    members: List[_Pending]
    offsets: np.ndarray            # (len(members),) start offset of each
    total: int
    ctx: object
    responses: List[MatchResponse] = field(default_factory=list)

    def __post_init__(self):
        self.responses = [MatchResponse() for _ in self.members]


@dataclass
class _WorkItem:
    sup: _Super
    pb: object                     # _PlannedBatch for queries [lo, lo+nq)
    lo: int
    last: bool


_SENTINEL = object()


class ERBatcher:
    """Dynamic super-batcher over an :class:`ERService` (module
    docstring). Use as a context manager, or call :meth:`close`.

    Parameters:
      * ``max_delay_s`` — flush-on-deadline latency bound: the oldest
        pending request never waits longer than this for the bucket to
        fill (queueing behind an in-flight super-batch can add more).
      * ``max_batch`` — flush-on-full size; defaults to the service's
        top query bucket so a full super-batch is one bucket-shaped
        dispatch. Requests larger than ``max_batch`` are accepted and
        internally sliced (they occupy a super-batch of their own).
      * ``tenant_rate`` / ``tenant_burst`` — per-tenant token-bucket
        admission in queries/s; None disables admission control.
    """

    def __init__(self, service: ERService, *, max_delay_s: float = 0.005,
                 max_batch: Optional[int] = None,
                 tenant_rate: Optional[float] = None,
                 tenant_burst: Optional[float] = None):
        self.service = service
        self.max_delay_s = float(max_delay_s)
        cap = service._buckets[-1]
        self.max_batch = int(max_batch) if max_batch is not None else cap
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._cap = cap
        self._tenant_rate = tenant_rate
        self._tenant_burst = (float(tenant_burst) if tenant_burst is not None
                              else float(max(self.max_batch, tenant_rate or 0)))
        self._tenants: Dict[str, _TokenBucket] = {}
        self._pending: deque = deque()
        self._cond = threading.Condition()
        self._outstanding = 0
        self._closed = False
        self._request_ids = itertools.count(1)
        # Depth-1 handoff queue == two-deep pipeline: one super-batch
        # planning (or planned, waiting) while one executes.
        import queue as _queue
        self._planned: _queue.Queue = _queue.Queue(maxsize=1)
        self.stats: Dict = {"requests": 0, "queries": 0, "rejected": 0,
                            "super_batches": 0, "max_fill": 0,
                            "flush_full": 0, "flush_deadline": 0}
        self._planner = threading.Thread(
            target=self._plan_loop, name="erbatcher-plan", daemon=True)
        self._executor = threading.Thread(
            target=self._exec_loop, name="erbatcher-exec", daemon=True)
        self._planner.start()
        self._executor.start()

    # -- client API ------------------------------------------------------

    def submit(self, query_titles: Sequence[str],
               tenant: str = "default") -> "Future[MatchResponse]":
        """Enqueue one micro-batch; resolves to the same
        :class:`MatchResponse` match set a sequential
        ``service.match(query_titles)`` would return."""
        titles = list(query_titles)
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("ERBatcher is closed")
            if self._tenant_rate is not None and titles:
                bucket = self._tenants.get(tenant)
                if bucket is None:
                    bucket = self._tenants[tenant] = _TokenBucket(
                        self._tenant_rate, self._tenant_burst)
                wait = bucket.try_take(len(titles))
                if wait > 0.0:
                    self.stats["rejected"] += 1
                    raise AdmissionError(
                        f"tenant {tenant!r} exceeded {self._tenant_rate} "
                        f"queries/s (burst {self._tenant_burst:g})",
                        retry_after_s=wait, tenant=tenant)
            self.stats["requests"] += 1
            self.stats["queries"] += len(titles)
            if not titles:
                fut.set_result(MatchResponse())
                return fut
            self._pending.append(_Pending(
                titles=titles, nq=len(titles), tenant=tenant,
                future=fut, arrived=time.monotonic(),
                queued=trace.start("batcher.queue",
                                   request=next(self._request_ids))))
            self._outstanding += 1
            self._cond.notify_all()
        return fut

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted request has resolved (or
        ``timeout`` seconds passed); returns whether the queue drained."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._outstanding > 0:
                rem = None if end is None else end - time.monotonic()
                if rem is not None and rem <= 0:
                    return False
                self._cond.wait(rem)
        return True

    def close(self):
        """Drain pending work, stop both threads. Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._planner.join()
        self._executor.join()

    def __enter__(self) -> "ERBatcher":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- planner thread --------------------------------------------------

    def _fill(self) -> int:
        return sum(p.nq for p in self._pending)

    def _take_members(self) -> Optional[List[_Pending]]:
        """Wait for work, honor the flush policy, pop one super-batch's
        members. Returns None when closed and drained."""
        with self._cond:
            while not self._pending:
                if self._closed:
                    return None
                self._cond.wait()
            # Accumulate until full or the OLDEST request's delay budget
            # is spent (closing flushes immediately).
            deadline = self._pending[0].arrived + self.max_delay_s
            while (self._fill() < self.max_batch and not self._closed):
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                self._cond.wait(rem)
            if self._fill() >= self.max_batch:
                self.stats["flush_full"] += 1
            else:
                self.stats["flush_deadline"] += 1
            members: List[_Pending] = [self._pending.popleft()]
            total = members[0].nq
            while self._pending and \
                    total + self._pending[0].nq <= self.max_batch:
                p = self._pending.popleft()
                members.append(p)
                total += p.nq
            self.stats["super_batches"] += 1
            self.stats["max_fill"] = max(self.stats["max_fill"], total)
            return members

    def _plan_loop(self):
        svc = self.service
        while True:
            members = self._take_members()
            if members is None:
                self._planned.put(_SENTINEL)
                return
            try:
                ctx = svc._new_request_ctx()
                for p in members:
                    p.queued.finish(super_batch=ctx.id)
                titles: List[str] = []
                offsets = np.zeros(len(members), np.int64)
                for i, p in enumerate(members):
                    offsets[i] = len(titles)
                    titles.extend(p.titles)
                sup = _Super(members=members, offsets=offsets,
                             total=len(titles), ctx=ctx)
                slices = list(range(0, sup.total, self._cap))
                for k, lo in enumerate(slices):
                    pb = svc._plan_batch(titles[lo:lo + self._cap],
                                         sup.ctx, record=True)
                    with trace.span("batcher.handoff", super_batch=ctx.id):
                        self._planned.put(_WorkItem(
                            sup=sup, pb=pb, lo=lo,
                            last=(k == len(slices) - 1)))
            except BaseException as e:      # plan failed: fail the super
                self._fail_super(members, e)

    # -- executor thread -------------------------------------------------

    def _exec_loop(self):
        svc = self.service
        while True:
            with trace.span("batcher.await_plan"):
                item = self._planned.get()
            if item is _SENTINEL:
                return
            sup = item.sup
            try:
                part = svc._execute_batch(item.pb, sup.ctx)
                with trace.span("batcher.demux", super_batch=sup.ctx.id):
                    self._demux(sup, part, item.lo)
                    if item.last:
                        self._resolve_super(sup)
            except BaseException as e:
                self._fail_super(sup.members, e)

    def _demux(self, sup: _Super, part: MatchResponse, lo: int):
        """Route one executed slice's pairs to the member covering each
        query offset; shared-fate metadata folds into every member."""
        offs = sup.offsets
        for a, b in part:
            g = lo + b
            i = int(np.searchsorted(offs, g, side="right")) - 1
            sup.responses[i].add((a, g - int(offs[i])))
        for resp in sup.responses:
            resp.attempts = max(resp.attempts, part.attempts)
            resp.recovered_tiles += part.recovered_tiles
            resp.planned_cost += part.planned_cost
            resp.scored_cost += part.scored_cost
            resp.steals += part.steals
            resp.stolen_tiles += part.stolen_tiles
            resp.degraded = resp.degraded or part.degraded

    def _resolve_super(self, sup: _Super):
        with self._cond:
            for p, resp in zip(sup.members, sup.responses):
                if not p.future.done():
                    p.future.set_result(resp)
                    self._outstanding -= 1
            self._cond.notify_all()

    def _fail_super(self, members: List[_Pending], exc: BaseException):
        with self._cond:
            for p in members:
                if not p.future.done():
                    p.future.set_exception(exc)
                    self._outstanding -= 1
            self._cond.notify_all()

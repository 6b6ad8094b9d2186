"""The program's own spans (``repro_torch.er.trace``) against the card's
idle time in a traced window.

While ``torch.profiler`` runs, the program records its spans (the
tracer follows the profiler's own flag), so a ``--trace 1`` window holds
both. :func:`reduce_program` reduces them by one rule: every idle
interval of the card inside the window, short gaps included, is cut at
span boundaries, and each piece goes to the innermost open span of the
**executor**, the thread that launches the device's work (the thread of
the ``stage1.score`` and ``stage2.verify`` spans: the main thread in a
batch cell, ``erbatcher-exec`` in a service cell). While the executor
waits in ``batcher.await_plan``, the piece goes to the innermost open
span of the **planner** (the thread of ``service.plan_batch``) as
``<span> (starved)``, or to ``batcher.await_plan (starved)`` when the
planner has none open. Idle time with no executor span open is
``NO_SPAN``.

Clocks: the profiler converts its host events to the Unix clock, the
clock of ``time.time_ns()`` that the program's spans read, so the spans
are taken as they are. (``Trace.summary`` shifts the harness's spans by
the window mark's start minus the host clock read just after it, which
is the mark's entry latency rather than an offset between clocks; the
result carries it as ``harness_shift_ns``.)

The accepted harness hands a metric reader the record alone, and the
record's ``trace`` holds sums, not intervals. :func:`program` therefore
reads the window's ``Trace`` from the frame that calls the reader, once,
and keeps the reduction in ``record["trace"]["program"]`` for the other
readers. A program without the tracer gives None, and so does every
reader of it; so does a window in which the tracer's buffer dropped
spans.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

NO_SPAN = "no program span"
AWAIT = "batcher.await_plan"
STARVED = " (starved)"
LAUNCHERS = ("stage1.score", "stage2.verify")
PLANNER = "service.plan_batch"
LONG_NS = 1_000_000          # device events this long are checked by name


def _thread_of(spans: List[Dict], names) -> Optional[str]:
    count: Dict[str, int] = {}
    for s in spans:
        if s["name"] in names:
            count[s["thread"]] = count.get(s["thread"], 0) + 1
    return max(count, key=count.get) if count else None


def _leaves(spans: List[Dict], bounds: np.ndarray) -> List[Optional[str]]:
    """For each elementary interval that starts at ``bounds[k]``, the
    innermost span (latest started, still open) of one thread's spans."""
    order = sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"]))
    out, stack, j = [], [], 0
    for t in bounds:
        while j < len(order) and order[j]["start_ns"] <= t:
            while stack and stack[-1]["end_ns"] <= order[j]["start_ns"]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1]["end_ns"] <= t:
            stack.pop()
        out.append(stack[-1]["name"] if stack else None)
    return out


def _busy_before(iv: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Busy ns in (-inf, t] for each t, over disjoint sorted intervals."""
    if not len(iv):
        return np.zeros(len(t), np.int64)
    length = iv[:, 1] - iv[:, 0]
    before = np.concatenate([[0], np.cumsum(length)])
    k = np.searchsorted(iv[:, 0], t, side="right")
    part = np.zeros(len(t), np.int64)
    has = k > 0
    idx = k[has] - 1
    part[has] = np.clip(t[has] - iv[idx, 0], 0, length[idx])
    return before[np.maximum(k - 1, 0)] * has + part


def _union(device: List[Tuple[int, int]], lo: int, hi: int) -> np.ndarray:
    """The union of the device's intervals inside [lo, hi]: (k, 2) sorted,
    disjoint."""
    iv = np.asarray(device, np.int64).reshape(-1, 2)
    iv = np.clip(iv, lo, hi)
    iv = iv[iv[:, 1] > iv[:, 0]]
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    first = np.concatenate([[True], iv[1:, 0] > reach[:-1]])
    last = np.concatenate([first[1:], [True]])
    return np.stack([iv[first, 0], reach[last]], axis=1)


def reduce_program(spans: List[Dict], device: List[Tuple[int, int]],
                   lo: int, hi: int) -> Dict:
    """The window [lo, hi] (ns): idle seconds by span (module docstring),
    and the count and seconds of every span that ended inside it."""
    busy = _union(device, lo, hi)
    executor = _thread_of(spans, LAUNCHERS)
    planner = _thread_of(spans, (PLANNER,))
    if planner == executor:
        planner = None
    mine = [s for s in spans if s["thread"] == executor]
    theirs = [s for s in spans if s["thread"] == planner]
    edges = {lo, hi}
    for s in mine + theirs:
        edges.update(t for t in (s["start_ns"], s["end_ns"]) if lo < t < hi)
    bounds = np.asarray(sorted(edges), np.int64)
    starts = bounds[:-1]
    idle_ns = (np.diff(bounds) - np.diff(_busy_before(busy, bounds)))
    leaf = _leaves(mine, starts)
    plan_leaf = _leaves(theirs, starts) if planner else [None] * len(starts)
    idle: Dict[str, float] = {}
    for k, ns in enumerate(idle_ns):
        if ns <= 0:
            continue
        name = leaf[k]
        if name is None:
            name = NO_SPAN
        elif name == AWAIT:
            name = (plan_leaf[k] or AWAIT) + STARVED
        idle[name] = idle.get(name, 0.0) + float(ns) * 1e-9
    ended: Dict[str, List] = {}
    for s in spans:
        if lo <= s["end_ns"] <= hi:
            row = ended.setdefault(s["name"], [0, 0.0])
            row[0] += 1
            row[1] += (s["end_ns"] - s["start_ns"]) * 1e-9
    window_s = (hi - lo) * 1e-9
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9
    return {"executor": executor, "planner": planner,
            "window_s": window_s, "idle_s": window_s - busy_s,
            "unattributed_s": idle.get(NO_SPAN, 0.0),
            "idle": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            "spans": ended}


def _window_trace():
    """The ``erbench.trace.Trace`` of the window, from a calling frame."""
    from erbench.trace import Trace

    frame = sys._getframe(1)
    while frame is not None:
        for value in list(frame.f_locals.values()):
            if isinstance(value, Trace) and value.prof is not None:
                return value
        frame = frame.f_back
    return None


def _from_window(tracer) -> Optional[Dict]:
    import torch

    from erbench.trace import WINDOW

    try:
        from repro_torch.er import trace as program_trace
    except ImportError:              # a program without the tracer
        return None
    spans = program_trace.collect()
    if not spans:
        return None
    cuda = torch.autograd.DeviceType.CUDA
    device, lo, hi = [], None, None
    for e in tracer.prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            start, length = e.start_ns(), e.duration_ns()
            # the window's mark, mirrored on the device as an annotation,
            # is no device work
            if length < LONG_NS or e.name() != WINDOW:
                device.append((start, start + length))
        elif lo is None and e.name() == WINDOW:
            lo = e.start_ns()
            hi = lo + e.duration_ns()
    if lo is None:
        return None
    out = reduce_program(spans, device, lo, hi)
    out["harness_shift_ns"] = lo - tracer.clock_ns
    out["dropped"] = program_trace.dropped()
    return out


def program(record: Dict) -> Optional[Dict]:
    """The reduction of the record's traced window (module docstring),
    computed by the first reader that asks and kept in the record. None
    when the tracer dropped spans: the window then lacks some of them."""
    tr = record.get("trace")
    if tr is None:
        return None
    if "program" not in tr:
        tracer = _window_trace()
        tr["program"] = _from_window(tracer) if tracer else None
    prog = tr["program"]
    return None if prog is None or prog.get("dropped") else prog


def mean_s(record: Dict, name: str, per: Optional[str] = None,
           kind: Optional[str] = None) -> Optional[float]:
    """Seconds of span ``name`` in the window over its count, or over the
    count of span ``per``; None outside ``kind`` records or without it."""
    if kind is not None and record.get("kind") != kind:
        return None
    prog = program(record)
    if not prog or name not in prog["spans"]:
        return None
    count, seconds = prog["spans"][name]
    if per is not None:
        count = prog["spans"].get(per, [0])[0]
    return seconds / count if count else None


def idle_pct(record: Dict, picked, kind: Optional[str] = None
             ) -> Optional[float]:
    """Idle time of the pieces whose name ``picked(name)`` accepts, as a
    share of the window (%)."""
    if kind is not None and record.get("kind") != kind:
        return None
    prog = program(record)
    if not prog or not prog["window_s"]:
        return None
    return 100.0 * sum(v for k, v in prog["idle"].items()
                       if picked(k)) / prog["window_s"]

"""Spans around the program's layers and the reading of the device trace.

With ``--trace 1`` the window runs under ``torch.profiler`` (host and
device activity). The harness marks the window and, from its own files,
wraps the calls into each layer in spans named ``<layer>.<call>``;
nothing inside the program changes. The reading
gives the device's busy time (the union of its kernel, copy and set
intervals inside the window), the time of each kernel by name, and the
idle gaps split among the innermost host spans that they overlap.
Device operations are named by their first ``NAME_CHARS`` characters.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

WINDOW = "erbench/window"
MIN_GAP_S = 100e-6        # shorter idle gaps are summed, not attributed
SHORT_GAPS = "gaps under 100 us"
NO_SPAN = "no span (harness)"
NAME_CHARS = 120


class Spans:
    """Host spans ``(start_ns, end_ns, name)`` on the wall clock, kept by
    wrappers that the harness puts around the program's layer calls.
    Recorded here rather than by ``record_function``, which the profiler
    sees only on the thread that started it."""

    def __init__(self):
        self.items: List[Tuple[int, int, str]] = []

    @contextlib.contextmanager
    def around(self, targets: Iterable[Tuple[object, str, str]], on: bool):
        """Wrap ``owner.attr`` in a span ``<name>`` for each target while
        ``on``; restore every attribute on exit."""
        saved = []
        if on:
            for owner, attr, name in targets:
                inner = getattr(owner, attr)

                @functools.wraps(inner)
                def wrapper(*args, _inner=inner, _name=name, **kwargs):
                    t0 = time.time_ns()
                    try:
                        return _inner(*args, **kwargs)
                    finally:
                        self.items.append((t0, time.time_ns(), _name))

                saved.append((owner, attr, inner))
                setattr(owner, attr, wrapper)
        try:
            yield
        finally:
            for owner, attr, inner in saved:
                setattr(owner, attr, inner)


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")() * 1000)


class Trace:
    """Profile the block when ``on``; :meth:`summary` reads the trace."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.spans = Spans()
        self.clock_ns = 0         # wall clock at the window's start

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        with self.prof:
            with torch.profiler.record_function(WINDOW):
                self.clock_ns = time.time_ns()
                yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    def summary(self) -> Optional[Dict]:
        if self.prof is None:
            return None
        device = []
        lo = hi = None
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            if name == WINDOW and e.device_type() != \
                    torch.autograd.DeviceType.CUDA:
                lo, hi = start, end
            elif (e.device_type() == torch.autograd.DeviceType.CUDA
                  and name != WINDOW):
                # The window's mark is mirrored on the device's timeline
                # as an annotation: not device work.
                device.append((start, end, name))
        if lo is None:
            return None
        shift = lo - self.clock_ns
        host = [(s + shift, e + shift, n) for s, e, n in self.spans.items]
        return reduce_trace(device, host, lo, hi)


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge (k, 2) intervals sorted by start."""
    if not len(iv):
        return iv
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, np.int64)


def _leaf_segments(host: List[Tuple[int, int, str]]
                   ) -> List[Tuple[int, int, str]]:
    """Cut the time the host spans cover into pieces, each named by the
    innermost (latest started) span that holds it."""
    bounds = sorted({t for s, e, _ in host for t in (s, e)})
    spans_ = sorted(host)
    segs, active, j = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while j < len(spans_) and spans_[j][0] <= a:
            active.append(spans_[j])
            j += 1
        active = [sp for sp in active if sp[1] > a]
        if active:
            segs.append((a, b, max(active)[2]))
    return segs


def reduce_trace(device: List[Tuple[int, int, str]],
                 host: List[Tuple[int, int, str]], lo: int, hi: int) -> Dict:
    """Busy and idle time of the device inside [lo, hi] (ns), the time of
    each device operation by name, and idle time by host span."""
    by_name: Dict[str, float] = {}
    iv = []
    for s, e, name in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        name = name[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
        iv.append((s, e))
    iv = _union(np.asarray(sorted(iv), np.int64).reshape(-1, 2))
    busy = float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9 if len(iv) else 0.0
    edges = np.concatenate([[lo], iv.ravel(), [hi]]) if len(iv) else \
        np.asarray([lo, hi])
    gaps = edges.reshape(-1, 2)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    idle: Dict[str, float] = {}
    long_ = (gaps[:, 1] - gaps[:, 0]) * 1e-9 >= MIN_GAP_S
    short_s = float((gaps[~long_, 1] - gaps[~long_, 0]).sum()) * 1e-9
    if short_s:
        idle[SHORT_GAPS] = short_s
    segs = _leaf_segments(host)
    seg_lo = np.asarray([a for a, _, _ in segs], np.int64)
    seg_hi = np.asarray([b for _, b, _ in segs], np.int64)
    for g0, g1 in gaps[long_]:
        left = int(g1 - g0)
        for k in range(int(np.searchsorted(seg_hi, g0, "right")),
                       int(np.searchsorted(seg_lo, g1, "left"))):
            a, b, name = segs[k]
            part = min(b, g1) - max(a, g0)
            if part > 0:
                idle[name] = idle.get(name, 0.0) + part * 1e-9
                left -= part
        if left > 0:
            idle[NO_SPAN] = idle.get(NO_SPAN, 0.0) + left * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(((n, float(v)) for n, v in idle.items()),
                      key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) * 1e-9, "busy_s": busy,
            "kernel_s": by_name,
            "breakdown": {"device_ops": [[n, v] for n, v in top],
                          "idle_gaps": [[n, v] for n, v in gaps_top]}}

"""Spans inside the port: one module-level recorder.

A span is a named interval of host work on one thread: ``run_er``, the
service's plan and execute halves, the batcher's queue and handoff
waits, stage 1 and stage 2. Each records

  * an id, and its parent's id (the innermost span open on the same
    thread, or one passed explicitly when the span crosses threads);
  * its name and the name of the thread that started it;
  * start and end in ns on ``time.time_ns()``, the wall clock that
    ``torch.profiler`` converts its host events to, so a reader can put
    the spans and a device trace on one timeline;
  * attributes given when it starts or finishes: the ids that tie one
    request or super-batch together (``request``, ``super_batch``; a
    span inherits them from its parent).

Recording is on between :func:`enable` and :func:`disable`, and while a
``torch.profiler`` session runs in the process (the profiler's own flag,
which every thread sees), so a profiled window carries the program's
spans with no switch of its own. Recorded spans stay in memory, in a
buffer of ``capacity`` spans that counts what it drops (:func:`dropped`);
:func:`collect` returns them. Nothing is written anywhere. Only
:func:`enable` empties the buffer, so a long profiled session that never
calls it fills the buffer once and drops every later span.

Off, a span appends nothing and records no parent: it reads the clock
twice, so callers that need a duration (``ERResult.extra["timings"]``,
``ERService.stats["seconds"]``) take it from the span.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

__all__ = ["CAPACITY", "Span", "span", "start", "enable", "disable",
           "recording", "collect", "dropped"]

CAPACITY = 1 << 17
INHERITED = ("request", "super_batch")

_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_state = {"on": False, "capacity": CAPACITY, "dropped": 0}
_buffer: List[tuple] = []


def recording() -> bool:
    """Whether a span started now is recorded."""
    return _state["on"] or getattr(_profiler, "_is_profiler_enabled", False)


def enable(capacity: int = CAPACITY) -> None:
    """Start recording into an empty buffer of ``capacity`` spans."""
    with _lock:
        _buffer.clear()
        _state.update(on=True, capacity=int(capacity), dropped=0)


def disable() -> None:
    """Stop recording; the buffer keeps what it holds."""
    _state["on"] = False


def collect() -> List[Dict]:
    """Every finished span recorded so far, in the order they ended."""
    with _lock:
        held = list(_buffer)
    return [{"id": i, "parent": p, "name": n, "thread": t, "start_ns": s,
             "end_ns": e, "attrs": a} for i, p, n, t, s, e, a in held]


def dropped() -> int:
    """Spans that ended while the buffer was full."""
    return _state["dropped"]


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span. As a context manager it nests under the innermost span
    open on its thread; :func:`start` begins one that another thread may
    :meth:`finish`. ``seconds`` is its duration once it has ended."""

    __slots__ = ("name", "attrs", "parent", "id", "thread", "start_ns",
                 "end_ns", "_on", "_pushed")

    def __init__(self, name: str, parent, attrs: Dict):
        self.name = name
        self.attrs = attrs
        self.parent = parent.id if isinstance(parent, Span) else parent
        self.id = None
        self.start_ns = self.end_ns = 0
        self._on = self._pushed = False

    def _begin(self, push: bool) -> "Span":
        if recording():
            self._on = True
            self.id = next(_ids)
            self.thread = threading.current_thread().name
            stack = _stack()
            if self.parent is None and stack:
                top = stack[-1]
                self.parent = top.id
                for k in INHERITED:
                    if k in top.attrs and k not in self.attrs:
                        self.attrs[k] = top.attrs[k]
            if push:
                stack.append(self)
                self._pushed = True
        self.start_ns = time.time_ns()
        return self

    def finish(self, **attrs) -> None:
        """End the span now, on whatever thread calls this."""
        self.end_ns = time.time_ns()
        if not self._on:
            return
        if self._pushed:
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
        self.attrs.update(attrs)
        rec = (self.id, self.parent, self.name, self.thread, self.start_ns,
               self.end_ns, self.attrs)
        with _lock:
            if len(_buffer) < _state["capacity"]:
                _buffer.append(rec)
            else:
                _state["dropped"] += 1

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self) -> "Span":
        return self._begin(push=True)

    def __exit__(self, *exc) -> bool:
        self.finish()
        return False


class _Inert:
    """What :func:`start` returns while off: finishing it does nothing."""

    def finish(self, **attrs) -> None:
        pass


_INERT = _Inert()


def span(name: str, parent: Optional[object] = None, **attrs) -> Span:
    """A span to open with ``with``; ``parent`` (a span or its id) for
    one whose cause ran on another thread."""
    return Span(name, parent, attrs)


def start(name: str, parent: Optional[object] = None, **attrs):
    """Begin a span that ends on another thread (its :meth:`Span.finish`).
    It is on no thread's stack, so nothing nests under it. While off it
    returns a shared object whose ``finish`` does nothing."""
    if not recording():
        return _INERT
    return Span(name, parent, attrs)._begin(push=False)

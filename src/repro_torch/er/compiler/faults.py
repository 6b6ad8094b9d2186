"""Deterministic fault injection for the supervised execution runtime.

Port of ``repro.er.compiler.faults`` (numpy, copied as it is: the same
seed gives the same script and the same corruption).

A *fault script* is a replayable sequence of :class:`FaultEvent`\\ s, each
armed at a global **step** — the number of device-shard calls the
injector has served so far. The supervisor
(:func:`compiler.execute.execute_supervised`) consults the injector
before every shard it scores, so the same script against the same
catalog replays the exact same chaos scenario, call for call. The
failure taxonomy (DESIGN.md §Fault tolerance):

  * ``kill``      — the device stops answering from this step on: every
                    shard call raises :class:`DeviceKilledError` until a
                    later ``revive`` event re-arms it. Models a lost
                    node / preempted VM.
  * ``revive``    — the device answers again (the circuit breaker's
                    probe path re-admits it at the service level).
  * ``straggle``  — ONE shard call on the device reports ``delay``
                    extra virtual seconds; the supervisor treats a call
                    whose (wall + injected) latency exceeds the shard
                    deadline as timed out and DISCARDS its output.
                    Models a slow disk / noisy neighbor. With
                    ``sticky=True`` the delay applies to EVERY call on
                    the device from its step on (a persistently slow
                    node — the work-stealing drill's straggler) until a
                    ``revive`` clears it.
  * ``transient`` — ONE shard call raises
                    :class:`TransientScorerError`; the device stays
                    healthy (retry-able). Models an RPC blip.
  * ``corrupt``   — ONE shard call returns garbage survivor rows
                    (seeded out-of-bounds indices), which the
                    supervisor's sanity check must catch and discard.
                    Models a bad host buffer / bit flip.

Delays are *virtual*: the injector reports them as numbers instead of
sleeping, so chaos suites run at full speed and stay deterministic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

import numpy as np

__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "FaultScript",
    "FaultInjector",
    "CallPlan",
    "DeviceKilledError",
    "TransientScorerError",
]

FAULT_KINDS = ("kill", "revive", "straggle", "transient", "corrupt")


class DeviceKilledError(RuntimeError):
    """The injected cluster lost this device: the shard call never
    returns. The supervisor marks the device unhealthy and reschedules
    its tiles."""


class TransientScorerError(RuntimeError):
    """A one-shot scorer failure (RPC blip): the shard is lost but the
    device stays healthy for the next round."""


@dataclass(frozen=True)
class FaultEvent:
    kind: str               # one of FAULT_KINDS
    device: int
    step: int               # arms once the injector has served >= step calls
    delay: float = 0.0      # straggle: virtual seconds added to the call
    sticky: bool = False    # straggle: delay EVERY call until revived

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclass(frozen=True)
class FaultScript:
    """An ordered, replayable chaos scenario over ``n_dev`` devices."""
    events: Tuple[FaultEvent, ...]
    n_dev: int

    @staticmethod
    def random(seed: int, n_dev: int, n_events: int, *,
               max_step: int = 32, straggle_delay: float = 1e9,
               fatal_frac: float = 1.0,
               allow_revive: bool = False) -> "FaultScript":
        """A seeded random script that NEVER makes every device fatal at
        once: kills and deadline-busting straggles consume a fatal
        budget of ``n_dev - 1`` devices; once spent, only non-fatal
        events (transient, corrupt, sub-deadline straggles) are drawn.
        ``straggle_delay`` is the virtual delay of a *fatal* straggle —
        pass something far above the supervisor's shard deadline.
        ``fatal_frac`` scales how much of the budget may be used."""
        rng = np.random.default_rng(seed)
        fatal: Set[int] = set()
        budget = max(int((n_dev - 1) * fatal_frac), 0)
        events: List[FaultEvent] = []
        for _ in range(n_events):
            step = int(rng.integers(0, max_step))
            dev = int(rng.integers(0, n_dev))
            kind = str(rng.choice(FAULT_KINDS))
            if kind == "revive":
                if not allow_revive or not fatal:
                    kind = "transient"
                else:
                    dev = int(rng.choice(sorted(fatal)))
                    fatal.discard(dev)
            if kind in ("kill", "straggle") and dev not in fatal:
                is_fatal = kind == "kill" or bool(rng.integers(0, 2))
                if is_fatal:
                    if len(fatal) >= budget:
                        kind = "transient" if kind == "kill" else "straggle"
                        is_fatal = False
                    else:
                        fatal.add(dev)
                if kind == "straggle":
                    delay = (straggle_delay if is_fatal
                             else 0.0)  # sub-deadline: harmless blip
                    events.append(FaultEvent("straggle", dev, step, delay))
                    continue
            if kind == "straggle":
                events.append(FaultEvent("straggle", dev, step, 0.0))
                continue
            events.append(FaultEvent(kind, dev, step))
        return FaultScript(events=tuple(events), n_dev=n_dev)


@dataclass
class CallPlan:
    """What the injector decided for one shard call."""
    delay: float = 0.0       # virtual seconds to add to the call's latency
    corrupt: bool = False    # garble this call's survivor output


class FaultInjector:
    """Replays a :class:`FaultScript` against a stream of shard calls.

    The supervisor calls :meth:`shard_call` before scoring each device
    shard; the injector advances its global step counter, arms every
    event whose step has been reached, and either raises (kill /
    transient) or returns a :class:`CallPlan` (possible straggle delay,
    possible output corruption). :meth:`corrupt_output` garbles a result
    with seeded out-of-bounds rows — always detectable by the
    supervisor's bounds check, by construction.
    """

    def __init__(self, script: FaultScript, seed: int = 0):
        self.script = script
        self.step = 0
        self._pending = sorted(script.events, key=lambda e: e.step)
        self._dead: Set[int] = set()
        self._straggle: Dict[int, List[float]] = {}
        self._slow: Dict[int, float] = {}
        self._transient: Dict[int, int] = {}
        self._corrupt: Dict[int, int] = {}
        self._rng = np.random.default_rng(seed)

    # -- script replay -------------------------------------------------

    def _arm(self):
        while self._pending and self._pending[0].step <= self.step:
            e = self._pending.pop(0)
            if e.kind == "kill":
                self._dead.add(e.device)
            elif e.kind == "revive":
                self._dead.discard(e.device)
                self._slow.pop(e.device, None)
            elif e.kind == "straggle":
                if e.sticky:
                    self._slow[e.device] = e.delay
                else:
                    self._straggle.setdefault(e.device, []).append(e.delay)
            elif e.kind == "transient":
                self._transient[e.device] = \
                    self._transient.get(e.device, 0) + 1
            elif e.kind == "corrupt":
                self._corrupt[e.device] = self._corrupt.get(e.device, 0) + 1

    def shard_call(self, device: int) -> CallPlan:
        """Account one shard call on ``device``; raise or return a plan."""
        self.step += 1
        self._arm()
        if device in self._dead:
            raise DeviceKilledError(f"device {device} is down")
        if self._transient.get(device, 0) > 0:
            self._transient[device] -= 1
            raise TransientScorerError(f"device {device}: transient fault")
        plan = CallPlan()
        plan.delay = self._slow.get(device, 0.0)
        q = self._straggle.get(device)
        if q:
            plan.delay += q.pop(0)
        if self._corrupt.get(device, 0) > 0:
            self._corrupt[device] -= 1
            plan.corrupt = True
        return plan

    # -- corruption ----------------------------------------------------

    def corrupt_output(self, rows_a: np.ndarray, rows_b: np.ndarray,
                       n_a: int, n_b: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Garble a shard's survivor rows: scramble a seeded subset and
        append at least one out-of-bounds pair, so the supervisor's
        cheap bounds check is guaranteed to reject the shard."""
        ra = np.array(rows_a, np.int64, copy=True)
        rb = np.array(rows_b, np.int64, copy=True)
        if ra.size:
            k = max(1, ra.size // 4)
            idx = self._rng.choice(ra.size, size=k, replace=False)
            ra[idx] = self._rng.integers(-n_a - 8, 2 * n_a + 8, size=k)
        extra = int(self._rng.integers(1, 4))
        ra = np.concatenate([ra, np.full(extra, n_a + 7, np.int64)])
        rb = np.concatenate([rb, np.full(extra, n_b + 7, np.int64)])
        return ra, rb

    # -- introspection -------------------------------------------------

    @property
    def dead_devices(self) -> Set[int]:
        """Devices currently down (ground truth, for drills/benchmarks)."""
        return set(self._dead)

    @property
    def slow_devices(self) -> Dict[int, float]:
        """Devices with a sticky straggle armed: device → per-call delay."""
        return dict(self._slow)

"""Straggle drill for runtime-feedback scheduling on the port (torch leg
of ``steal_bench``): the Fig. 9 robustness workload (b = 100 blocks,
|Φ_k| ∝ e^{−s·k}, s = 1.0) on 8 logical device shards of the leg's
device, two of which carry a seeded sticky straggle — every shard call
on them pays a fixed virtual delay.

Each strategy runs twice through ``execute_supervised`` with the same
dispatch quantum: static (no stealing) and with the EWMA feedback model
and mid-stream work stealing. Asserted in :func:`measure` (exact): both
runs return the failure-free survivor set with coverage 1.0, the static
run never steals and the steal run steals at least once. Asserted in
:func:`check` (the bar, on the makespan the records measure): stealing
cuts the makespan by at least ``WIN_FLOOR``. Stage 1 runs K1 on the card.

    PYTHONPATH=src python -m benchmarks.torch_steal_bench [--quick] [--device cpu|cuda]
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.er.compiler import (EwmaCostModel, FaultEvent, FaultInjector,
                                     FaultScript, execute, execute_supervised)

from .common import print_table, save_rows, timer
from .torch_chaos_bench import N_DEV, THRESH, _pairs, _workload
from .torch_common import cli, count_view, impl_of

SLOW_DEVICES = (1, 6)        # seeded stragglers (of N_DEV = 8)
SLOW_DELAY_S = 0.25          # virtual seconds added to EVERY call on them
QUANTUM = 8                  # dispatch batch size, identical in both modes
STEAL_FACTOR = 2.0           # steal when projected finish > 2× fleet median
WIN_FLOOR = 1.5              # minimum static/steal makespan ratio
# The columns that equal the JAX leg's row for row; the steal counts and
# makespans follow from clocks.
COUNTS = ("strategy", "mode", "tiles", "exact")


def _script() -> FaultScript:
    return FaultScript(events=tuple(
        FaultEvent("straggle", d, 0, delay=SLOW_DELAY_S, sticky=True)
        for d in SLOW_DEVICES), n_dev=N_DEV)


def _run(cat, feats, want, steal: bool, dev):
    ra, rb, rep = execute_supervised(
        cat, feats, threshold=THRESH, n_dev=N_DEV, max_retries=2,
        backoff=0.0, injector=FaultInjector(_script()),
        steal_quantum=QUANTUM,
        steal_factor=STEAL_FACTOR if steal else None,
        feedback=EwmaCostModel(N_DEV) if steal else None,
        impl=impl_of(dev), device=dev)
    assert _pairs(ra, rb) == want, "diverged from the quiet match set"
    assert rep.coverage == 1.0 and rep.lost_tiles == 0
    return rep


def drill(n: int, r: int, dev):
    cats, feats = _workload(n, r)
    feats = torch.from_numpy(feats).to(dev)
    rows = []
    for strat, cat in cats.items():
        want = _pairs(*execute(cat, feats, threshold=THRESH,
                               impl=impl_of(dev), device=dev))
        reps = {}
        for mode in ("static", "steal"):
            with timer() as t:
                rep = reps[mode] = _run(cat, feats, want, mode == "steal",
                                        dev)
            rows.append({
                "strategy": strat, "mode": mode, "tiles": cat.num_tiles,
                "steals": rep.steals, "stolen_tiles": rep.stolen_tiles,
                "makespan_s": round(rep.measured_makespan_s, 4),
                "injected_s": round(sum(rec.injected_delay
                                        for rec in rep.records), 4),
                "real_s": round(sum(rec.elapsed for rec in rep.records), 4),
                "wall_s": round(t.seconds, 4),
                "exact": True,
            })
        static, stolen = reps["static"], reps["steal"]
        assert static.steals == 0
        assert stolen.steals >= 1, (strat, "no steal ever triggered")
        win = static.measured_makespan_s / max(stolen.measured_makespan_s,
                                               1e-12)
        rows.append({
            "strategy": strat, "mode": "win", "tiles": cat.num_tiles,
            "steals": stolen.steals, "stolen_tiles": stolen.stolen_tiles,
            "makespan_s": round(win, 2), "exact": True,
        })
    return rows


def measure(n: int = 4_000, r: int = 32, quick: bool = False, device="cuda"):
    dev = resolve_device(device)
    if quick:
        n = 1_200
    rows = drill(n, r, dev)
    print_table(
        f"steal_bench — sticky stragglers {list(SLOW_DEVICES)} "
        f"(+{SLOW_DELAY_S}s/call) over n={n}, s=1.0, n_dev={N_DEV}, "
        f"quantum={QUANTUM} on {dev} (mode=win: makespan_s is static/steal "
        f"ratio)", rows,
        cols=["strategy", "mode", "tiles", "steals", "stolen_tiles",
              "makespan_s", "injected_s", "real_s", "exact"])
    path = save_rows("torch_steal_bench", rows)
    wins = [row["makespan_s"] for row in rows if row["mode"] == "win"]
    print(f"\nall strategies exact; makespan wins {wins} "
          f"(floor {WIN_FLOOR}×) — {path}")
    return rows


def counts(rows):
    """The count columns, in row order."""
    return count_view(rows, COUNTS)


def check(rows):
    """The bar: stealing cuts each strategy's makespan by WIN_FLOOR."""
    for row in rows:
        if row["mode"] == "win":
            assert row["makespan_s"] >= WIN_FLOOR, (row["strategy"],
                                                    row["makespan_s"])


def run(n: int = 4_000, quick: bool = False, device="cuda"):
    rows = measure(n, quick=quick, device=device)
    check(rows)
    return rows


if __name__ == "__main__":
    raise SystemExit(cli(run, __doc__))

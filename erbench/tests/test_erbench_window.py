"""Window arithmetic: whole runs only, a rate over the window, a p95 over
every request."""
import importlib.util
from pathlib import Path

import pytest

from erbench.drivers import batch
from erbench.tests.helpers import small_cell

METRICS = Path(__file__).resolve().parent.parent / "metrics"


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_window_closes_after_the_first_run_past_the_length(monkeypatch):
    clock = _Clock()

    class Res:
        matches, total_pairs = set(), 7
        extra = {"timings": {"plan_s": 1.0}}

    def fake_run_er(titles, cfg, device):
        clock.t += 3.0          # every run takes 3 s
        return Res()

    monkeypatch.setattr(batch.time, "perf_counter", clock)
    from repro_torch.er import pipeline
    monkeypatch.setattr(pipeline, "run_er", fake_run_er)
    cell = small_cell("ds1_products.batch_pair_range", seconds=10.0)
    state = {"titles": ["t"] * 100, "cfg": None, "er": {"feature_dim": 256}}

    class Off:
        on = False

        def window(self):
            import contextlib
            return contextlib.nullcontext()

    from erbench.check import SurvivorLog
    import contextlib
    rec = batch.window(state, cell, SurvivorLog(), Off(),
                       contextlib.nullcontext())
    assert len(rec["runs"]) == 4 and rec["window_s"] == 12.0
    assert rec["live_pairs"] == 28
    assert _reader("batch_entities_per_s")(rec) == pytest.approx(400 / 12.0)
    assert _reader("compiler.plan_s")(rec) == 1.0


def test_p95_is_nearest_rank_over_every_request():
    rec = {"kind": "service", "latencies_ms": list(range(1, 101))}
    assert _reader("batcher.p95_ms")(rec) == 95
    rec["latencies_ms"] = [5.0] * 19 + [100.0]
    assert _reader("batcher.p95_ms")(rec) == 5.0
    rec["latencies_ms"] = [5.0] * 18 + [100.0, 200.0]
    assert _reader("batcher.p95_ms")(rec) == 100.0


def test_service_rate_and_fill():
    rec = {"kind": "service", "queries": 5000, "window_s": 2.5,
           "batcher": {"queries": 5000, "super_batches": 20},
           "service": {"seconds": 2.0, "batches": 20}}
    assert _reader("service_queries_per_s")(rec) == 2000.0
    assert _reader("batcher.fill")(rec) == 250.0
    assert _reader("service.batch_ms")(rec) == pytest.approx(100.0)
    assert _reader("batch_entities_per_s")(rec) is None

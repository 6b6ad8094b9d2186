"""The torch legs of the supervisor's benchmarks (group d):
``chaos_bench`` (executor and service drills under fault scripts) and
``steal_bench`` (static vs work stealing under sticky stragglers),
beside their JAX legs at ``--smoke`` size on the CPU. Every count column
must be equal row for row — the rounds, retries and recovered tiles of
each scripted drill included; the steal counts and makespans are clocks
and are not compared."""
import json

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
import torch_parity as tp  # noqa: E402


@pytest.mark.parametrize("name", ["chaos_bench", "steal_bench"])
def test_counts_equal_the_jax_leg(name, monkeypatch, tmp_path):
    ref, port = tp.bench_legs(name, monkeypatch, tmp_path)
    want = ref.run(quick=True)
    got = port.measure(quick=True, device="cpu")
    assert port.counts(got) == port.counts(want)
    assert all(r["exact"] for r in got)
    saved = json.loads((tmp_path / f"torch_{name}.json").read_text())
    assert port.counts(saved) == port.counts(got)


def test_steal_bar(monkeypatch, tmp_path):
    _, port = tp.bench_legs("steal_bench", monkeypatch, tmp_path)
    rows = [{"strategy": "basic", "mode": "static", "makespan_s": 9.0},
            {"strategy": "basic", "mode": "win", "makespan_s": 1.5}]
    port.check(rows)
    rows[1]["makespan_s"] = 1.49
    with pytest.raises(AssertionError):
        port.check(rows)


def test_the_steal_leg_keeps_the_chaos_workload(monkeypatch, tmp_path):
    """steal_bench borrows chaos_bench's workload: the torch legs share
    theirs, never the JAX legs'."""
    _, chaos = tp.bench_legs("chaos_bench", monkeypatch, tmp_path)
    _, steal = tp.bench_legs("steal_bench", monkeypatch, tmp_path)
    assert steal._workload is chaos._workload
    assert (steal.N_DEV, steal.THRESH) == (chaos.N_DEV, chaos.THRESH) == (
        8, 0.4)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", ["chaos_bench", "steal_bench"])
def test_the_card_is_the_default(name, monkeypatch, tmp_path):
    _, port = tp.bench_legs(name, monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.measure(quick=True)

"""The torch legs of the mesh benchmarks (group e): ``mesh_bench`` (the
gather policies, the data × model mesh and the multi-hop halo on logical
shards of one device) and ``fig13_scaling`` (plan-math node scaling plus
its measured mesh part), at ``--smoke`` size on the CPU. Every count
column equals the tracked JAX output row for row (the bytes per device
included); the mesh leg also equals a CPU run of the JAX leg's
subprocess. Wall times and makespans are clocks and are not compared."""
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
import torch_parity as tp  # noqa: E402

TRACKED = Path(__file__).resolve().parents[1] / "benchmarks" / "out"


@pytest.mark.parametrize("name", ["mesh_bench", "fig13_scaling"])
def test_counts_equal_the_tracked_jax_output(name, monkeypatch, tmp_path):
    _, port = tp.bench_legs(name, monkeypatch, tmp_path)
    want = json.loads((TRACKED / f"{name}.json").read_text())
    got = port.measure(quick=True, device="cpu")
    assert port.counts(got) == port.counts(want)
    port.check(got)
    saved = json.loads((tmp_path / f"torch_{name}.json").read_text())
    assert port.counts(saved) == port.counts(got)


def test_mesh_leg_equals_the_jax_leg_run(monkeypatch, tmp_path):
    """The (4, 2) data × model leg against the JAX leg's own subprocess
    (8 simulated host devices): the comms rows' bytes, psum bytes and
    matches, and the halo row's hops."""
    ref, port = tp.bench_legs("mesh_bench", monkeypatch, tmp_path)
    want = ref._leg(4, 2, 640)
    got = port.leg(4, 2, 640, torch.device("cpu"))
    assert port.counts(got) == port.counts(want)
    assert [r["leg"] for r in got] == ["comms"] * 3 + ["halo"]


def test_mesh_check_holds_ring_2x_below_flat(monkeypatch, tmp_path):
    _, port = tp.bench_legs("mesh_bench", monkeypatch, tmp_path)
    rows = [{"leg": "comms", "policy": p, "n_data": 16, "n_model": 1,
             "gather_bytes_per_dev": b}
            for p, b in (("flat", 1000), ("ring", 500))]
    port.check(rows)
    rows[1]["gather_bytes_per_dev"] = 501
    with pytest.raises(AssertionError, match="not >= 2x below flat"):
        port.check(rows)


def test_mesh_measure_refuses_a_fallback(monkeypatch, tmp_path):
    """A plan that degrades to flat fails the leg's exact checks."""
    _, port = tp.bench_legs("mesh_bench", monkeypatch, tmp_path)
    real = port.leg

    def degraded(*args):
        rows = real(*args)
        rows[1]["fallback"] = "strip span too wide"
        return rows

    monkeypatch.setattr(port, "leg", degraded)
    with pytest.raises(AssertionError, match="degraded to flat"):
        port.measure(device="cpu", legs=((4, 1, 300),))


@pytest.mark.parametrize("name", ["mesh_bench", "fig13_scaling"])
def test_the_card_is_the_default(name, monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    _, port = tp.bench_legs(name, monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.measure(quick=True)

"""The torch legs of the paper's figures (group a): ``fig9_skew``,
``fig10_reduce_tasks``, ``fig11_sorted``, ``fig_sn_window`` on the port's
``run_er``, and the host-only ``fig8_datasets``, ``fig12_map_output``
and ``schedule_bench``. Each runs beside its JAX leg at one reduced size
on the CPU; the count columns (each leg's ``counts``) must be equal row
for row. No clock is compared."""
import json

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
import torch_parity as tp  # noqa: E402

# leg -> the reduced size both legs run at
SIZES = {
    "fig9_skew": dict(n=500),
    "fig10_reduce_tasks": dict(n=500),
    "fig11_sorted": dict(n=1_000),
    "fig_sn_window": dict(n=1_000),
    "fig8_datasets": dict(ds1_n=3_000, ds2_n=4_000),
    "fig12_map_output": dict(n=2_000),
    "schedule_bench": dict(n=2_000),
}


@pytest.mark.parametrize("name", SIZES)
def test_counts_equal_the_jax_leg(name, monkeypatch, tmp_path):
    ref, port = tp.bench_legs(name, monkeypatch, tmp_path)
    want = ref.run(**SIZES[name])
    got = port.measure(**SIZES[name], device="cpu")
    assert port.counts(got) == port.counts(want)
    assert len(got) == len(want) and got
    saved = json.loads((tmp_path / f"torch_{name}.json").read_text())
    assert port.counts(saved) == port.counts(got)
    port.check(got)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", SIZES)
def test_the_card_is_the_default(name, monkeypatch, tmp_path):
    """Without a card and without ``device="cpu"`` a leg raises."""
    _, port = tp.bench_legs(name, monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.measure(quick=True)
    assert not list(tmp_path.iterdir())


def test_command_line(monkeypatch, tmp_path):
    """``python -m benchmarks.torch_<name> --quick --device cpu``."""
    _, port = tp.bench_legs("fig12_map_output", monkeypatch, tmp_path)
    assert port.cli(port.run, port.__doc__, ["--quick", "--device",
                                             "cpu"]) == 0
    rows = json.loads((tmp_path / "torch_fig12_map_output.json").read_text())
    assert len(rows) == 15 and rows[0]["map_kv_pairs"] == 7_999
    with pytest.raises(SystemExit):
        port.cli(port.run, port.__doc__, ["--device", "tpu"])

"""The torch leg of ``kernel_bench`` (group b): the dense
``ops.pair_scores`` suite and the tile-catalog executor against the
numpy stage 1, beside the JAX leg at its ``--smoke`` size on the CPU.
The count columns must be equal row for row (the survivors included),
the torch leg writes no ``BENCH_pair_sim.json``, and a survivor-set
difference is allowed only within NEAR of the threshold."""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
import torch_parity as tp  # noqa: E402

BENCH_JSON = Path(__file__).resolve().parents[1] / "BENCH_pair_sim.json"


def _digest():
    return hashlib.sha256(BENCH_JSON.read_bytes()).hexdigest()


def test_dense_counts_equal_the_jax_leg(monkeypatch, tmp_path):
    ref, port = tp.bench_legs("kernel_bench", monkeypatch, tmp_path)
    want = ref.run(quick=True)
    got = port.measure(quick=True, device="cpu")
    assert port.counts(got) == port.counts(want) and got
    assert {r["impl"] for r in got} == {"torch"}
    assert all(r["bf16_s"] > 0 for r in got)
    port.check(got)


def test_catalog_counts_equal_the_jax_leg(monkeypatch, tmp_path):
    """``run_catalog(quick=True)`` of both legs (the JAX leg's smoke
    branch writes no ``BENCH_pair_sim.json``; the torch leg never does)."""
    ref, port = tp.bench_legs("kernel_bench", monkeypatch, tmp_path)
    before = _digest()
    want = ref.run_catalog(quick=True)
    got = port.measure_catalog(quick=True, device="cpu")
    assert _digest() == before
    assert port.catalog_counts(got) == port.catalog_counts(want)
    assert got[0]["survivors"] > 0 and got[0]["near_flips"] == 0
    saved = json.loads((tmp_path / "torch_kernel_bench_catalog.json")
                       .read_text())
    assert port.catalog_counts(saved) == port.catalog_counts(got)
    port.check_catalog(got)      # the 5x bar is the card's only


def test_catalog_bar_is_the_cards(monkeypatch, tmp_path):
    _, port = tp.bench_legs("kernel_bench", monkeypatch, tmp_path)
    row = {"impl": "cuda", "speedup": 4.9}
    with pytest.raises(AssertionError, match="speedup"):
        port.check_catalog([row])
    port.check_catalog([dict(row, speedup=5.0)])
    port.check_catalog([dict(row, impl="torch")])


def test_near_flips(monkeypatch, tmp_path):
    """A pair kept by one side only passes when its f64 score is within
    NEAR of the threshold, and raises otherwise."""
    _, port = tp.bench_legs("kernel_bench", monkeypatch, tmp_path)
    thr = 0.15
    feats = np.zeros((3, 2), np.float32)
    feats[:, 0] = 1.0
    feats[1, 0] = np.float32(thr)                # (0, 1) scores thr
    feats[2, 0] = np.float32(0.5)                # (0, 2) scores 0.5
    flips = port.near_flips({(0, 1)}, set(), feats, thr)
    assert [(a, b) for a, b, _ in flips] == [(0, 1)]
    assert port.near_flips({(0, 2)}, {(0, 2)}, feats, thr) == []
    with pytest.raises(AssertionError, match="away from the threshold"):
        port.near_flips(set(), {(0, 2)}, feats, thr)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("fn", ["measure", "measure_catalog"])
def test_the_card_is_the_default(fn, monkeypatch, tmp_path):
    _, port = tp.bench_legs("kernel_bench", monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(port, fn)(quick=True)

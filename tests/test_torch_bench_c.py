"""The torch legs of the service benchmarks (group c): ``serve_bench``
(sequential ``match`` vs ``ERBatcher``) and ``tune_bench`` (the lattice
sweep, the model's pick, the autotuning service), beside their JAX legs
at one reduced size on the CPU. The count columns must be equal row for
row (``tune_bench`` per geometry, and the model's pick); no clock is
asserted — the JAX legs' wall-time bars are kept from failing the test
(the serve bar's error is caught after its rows were saved, the tune
bar set to 0), and the torch legs' bars are not run."""
import json

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
import torch_parity as tp  # noqa: E402

BUCKETS = (8, 32)     # the legs' four buckets cut to two, on both sides


def _buckets(monkeypatch, mod):
    orig = mod.ServiceConfig
    monkeypatch.setattr(mod, "ServiceConfig", lambda **kw: orig(
        **{**kw, "query_buckets": BUCKETS}))


def test_serve_counts_equal_the_jax_leg(monkeypatch, tmp_path):
    ref, port = tp.bench_legs("serve_bench", monkeypatch, tmp_path)
    _buckets(monkeypatch, ref)
    _buckets(monkeypatch, port)
    size = dict(n=1_000, batches_per_size=6)
    try:
        want = ref.run(**size)
    except AssertionError as e:           # the wall-time bar, after save
        assert "super-batching speedup" in str(e), e
        want = json.loads((tmp_path / "serve_bench.json").read_text())
    got = port.measure(**size, device="cpu")
    assert port.counts(got) == port.counts(want)
    assert [r["batch_size"] for r in got] == list(BUCKETS)
    assert all(r["matches"] > 0 for r in got)
    saved = json.loads((tmp_path / "torch_serve_bench.json").read_text())
    assert port.counts(saved) == port.counts(got)


def test_tune_counts_equal_the_jax_leg(monkeypatch, tmp_path):
    ref, port = tp.bench_legs("tune_bench", monkeypatch, tmp_path)
    monkeypatch.setattr(ref, "SPEEDUP_BAR", 0.0)
    size = dict(n=800, d=64, r=20, m=4, svc_n=600)
    want = ref.run(**size)
    want = json.loads((tmp_path / "tune_bench.json").read_text())
    got = port.measure(**size, device="cpu")
    assert port.counts(got) == port.counts(want)
    assert len(port.counts(got)) == 16
    svc = [r for r in got if r.get("leg") == "service"]
    assert len(svc) == 1 and svc[0]["steady_compiles"] == 0


def test_bars(monkeypatch, tmp_path):
    """The torch legs' wall-time bars read the rows they are given."""
    _, serve = tp.bench_legs("serve_bench", monkeypatch, tmp_path)
    serve.check([{"batch_size": 8, "speedup": 3.0}])
    with pytest.raises(AssertionError, match="below 3.0x"):
        serve.check([{"batch_size": 8, "speedup": 2.9}])
    _, tune = tp.bench_legs("tune_bench", monkeypatch, tmp_path)
    row = {"autotuned": "64x64", "speedup_vs_128": 1.2,
           "feedback_pick": "32x32", "measured_best": "32x32"}
    tune.check([row])
    with pytest.raises(AssertionError, match="bar 1.2x"):
        tune.check([dict(row, speedup_vs_128=1.19)])
    with pytest.raises(AssertionError, match="measured best"):
        tune.check([dict(row, feedback_pick="64x64")])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", ["serve_bench", "tune_bench"])
def test_the_card_is_the_default(name, monkeypatch, tmp_path):
    _, port = tp.bench_legs(name, monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.measure(quick=True)

"""The match set that ``run_er`` builds from stage 2's hits, on the CPU:
equal to the JAX package's ``run_er`` on small DS1- and DS2-law corpora,
with and without key-less titles, on the catalog and the reference
executor, as ``(min, max)`` tuples of ints; its ``pipeline.collect``
span in both jobs and the ``stage1.decode`` span inside stage 1."""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.er as jer  # noqa: E402
import repro_torch.er as ter  # noqa: E402
from repro_torch.er import trace  # noqa: E402
import torch_parity  # noqa: E402,F401  (one intra-op thread a worker)

BASE = dict(r=8, m=4, feature_dim=128, max_len=48, block_m=32, block_n=64)


def _corpus(law, keyless):
    ds = (ter.make_products(900, seed=5) if law == "ds1"
          else ter.make_publications(900, seed=5))
    titles = list(ds.titles)
    if keyless:
        titles = ["  " if i % 37 == 0 else t for i, t in enumerate(titles)]
    return titles


@pytest.mark.parametrize("law", ["ds1", "ds2"])
@pytest.mark.parametrize("keyless", [False, True])
@pytest.mark.parametrize("executor", ["catalog", "reference"])
def test_match_set_equals_reference_package(law, keyless, executor):
    titles = _corpus(law, keyless)
    got = ter.run_er(titles, ter.ERConfig(executor=executor, **BASE),
                     device="cpu")
    want = jer.run_er(titles, jer.ERConfig(executor=executor,
                                           kernel_impl="xla", **BASE))
    assert got.matches == want.matches and len(got.matches) > 10
    assert all(type(a) is int and type(b) is int and a < b
               for a, b in got.matches)
    if keyless:
        assert got.extra["null_key_pairs"] > 0


def test_collect_and_decode_spans():
    trace.enable()
    try:
        ter.run_er(_corpus("ds2", True), ter.ERConfig(**BASE), device="cpu")
        spans = trace.collect()
    finally:
        trace.disable()
    by_id = {s["id"]: s for s in spans}

    def parents(name):
        return sorted(by_id[s["parent"]]["name"] for s in spans
                      if s["name"] == name)
    assert parents("pipeline.collect") == ["pipeline.cross",
                                           "pipeline.run_er"]
    assert parents("stage1.decode") == ["stage1.score", "stage1.score"]
    assert all(s["attrs"] == {} for s in spans)


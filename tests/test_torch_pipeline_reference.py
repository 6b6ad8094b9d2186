"""The port's reference executor (materialized per-reducer pairs, paired
dots, the same verifier) against the JAX package's reference executor:
equal results for every strategy, with and without key-less titles. The
catalog executor is held to the JAX package in test_torch_pipeline.py."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.er as jer  # noqa: E402
import repro_torch.er as ter  # noqa: E402
from torch_parity import keyless, skewed_corpus  # noqa: E402

STRATEGIES = ("basic", "block_split", "pair_range", "sorted_neighborhood")
BASE = dict(r=8, m=4, window=12, feature_dim=128, max_len=48)


@pytest.fixture(scope="module")
def corpus():
    titles, bid = skewed_corpus()
    return {False: (titles, bid), True: keyless(titles, bid)}


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("with_keyless", [False, True])
def test_reference_executor_equals_reference_package(corpus, strategy,
                                                     with_keyless):
    titles, bid = corpus[with_keyless]
    cfg = dict(strategy=strategy, executor="reference", **BASE)
    got = ter.run_er(titles, ter.ERConfig(**cfg), block_ids=bid,
                     device="cpu")
    want = jer.run_er(titles, jer.ERConfig(**cfg), block_ids=bid)
    assert got.matches == want.matches
    assert got.total_pairs == want.total_pairs
    assert got.map_output_size == want.map_output_size
    np.testing.assert_array_equal(got.reducer_pairs, want.reducer_pairs)
    assert got.schedule is None and want.schedule is None

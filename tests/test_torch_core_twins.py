"""The port's static-shape torch twins of the reference's jit-able core
twins, exact on seeded numpy inputs: ``greedy_lpt_torch`` against
``greedy_lpt_jnp`` (ties, zero weights, more bins than tasks),
``compute_bdm_torch`` against ``compute_bdm_jnp`` and
``entity_indices_torch`` against ``entity_indices_jnp`` (empty blocks and
partitions), and each against its numpy twin. Seeded cases, no
hypothesis."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro.core.assignment import greedy_lpt_jnp  # noqa: E402
from repro.core.bdm import compute_bdm_jnp, entity_indices_jnp  # noqa: E402
from repro_torch.core import (compute_bdm, compute_bdm_torch,  # noqa: E402
                              entity_indices, entity_indices_torch,
                              greedy_lpt, greedy_lpt_torch)

LPT_CASES = [  # (tasks, bins, weight range, seed)
    (1, 1, 10, 0), (7, 3, 2, 1), (40, 6, 4, 2), (64, 8, 1000, 3),
    (5, 9, 3, 4), (33, 4, 1, 5), (128, 16, 50, 6)]


def _lpt_weights(t, hi, seed):
    w = np.random.default_rng(seed).integers(0, hi, t).astype(np.int32)
    w[::5] = w[0]              # repeated weights: ties in the sort and loads
    return w


@pytest.mark.parametrize("t,r,hi,seed", LPT_CASES)
def test_greedy_lpt_torch_equals_jnp(t, r, hi, seed):
    w = _lpt_weights(t, hi, seed)
    a_j, l_j = greedy_lpt_jnp(jnp.asarray(w), r)
    a_t, l_t = greedy_lpt_torch(torch.from_numpy(w), r)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    assert l_t.dtype == torch.int32
    a_n, l_n = greedy_lpt(w, r)
    np.testing.assert_array_equal(a_t.numpy(), a_n)
    np.testing.assert_array_equal(l_t.numpy(), l_n)


def test_greedy_lpt_torch_ties_go_to_the_lowest_bin():
    a, loads = greedy_lpt_torch(torch.tensor([3, 3, 3, 3, 0, 0]), 4)
    assert a.tolist() == [0, 1, 2, 3, 0, 0]   # zero weights keep bin 0 least
    assert loads.tolist() == [3, 3, 3, 3]


BDM_CASES = [  # (entities, blocks, partitions, seed)
    (1, 1, 1, 0), (50, 7, 3, 1), (200, 30, 8, 2), (33, 12, 5, 3),
    (500, 4, 16, 4)]


def _bdm_inputs(n, b, m, seed):
    rng = np.random.default_rng(seed)
    # skewed block ids, the top blocks and partition 0 never drawn: empty
    # rows and an empty column
    bid = np.minimum(rng.geometric(0.3, n) - 1, max(b - 2, 0))
    pid = rng.integers(min(1, m - 1), m, n)
    return bid.astype(np.int64), pid.astype(np.int64)


@pytest.mark.parametrize("n,b,m,seed", BDM_CASES)
def test_compute_bdm_torch_equals_jnp(n, b, m, seed):
    bid, pid = _bdm_inputs(n, b, m, seed)
    want = np.asarray(compute_bdm_jnp(jnp.asarray(bid), jnp.asarray(pid),
                                      b, m))
    got = compute_bdm_torch(torch.from_numpy(bid), torch.from_numpy(pid),
                            b, m)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), compute_bdm(bid, pid, b, m))
    if b > 1:
        assert (got.numpy()[-1] == 0).all()


@pytest.mark.parametrize("n,b,m,seed", BDM_CASES)
def test_entity_indices_torch_equals_jnp(n, b, m, seed):
    bid, pid = _bdm_inputs(n, b, m, seed)
    bdm = compute_bdm(bid, pid, b, m)
    want = np.asarray(entity_indices_jnp(jnp.asarray(bid), jnp.asarray(pid),
                                         jnp.asarray(bdm)))
    got = entity_indices_torch(torch.from_numpy(bid), torch.from_numpy(pid),
                               torch.from_numpy(bdm))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  entity_indices(bid, pid, bdm))

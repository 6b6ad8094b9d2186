"""The port's mesh comms planner (``repro_torch.er.compiler.comms``)
against the JAX package's (``repro.er.compiler.comms``). Both are numpy,
so they run side by side in this process on the catalogs of
tests/test_mesh_comms.py, lowered by each package from the same block
sizes: every ``CommsPlan`` field, the byte dicts, ``summary()``, the
``fallback`` strings, ``comms_volume`` up to 64 devices and
``rewrite_tiles_local`` must be equal."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (one intra-op thread per worker)
from repro.core import compute_bdm as j_compute_bdm  # noqa: E402
from repro.core import plan_pair_range as j_plan_pair_range  # noqa: E402
from repro.er import compiler as jc  # noqa: E402
from repro_torch.core import compute_bdm, plan_pair_range  # noqa: E402
from repro_torch.er import compiler as tc  # noqa: E402
from repro_torch.er.compiler.ir import (A_TILE, BAND, NCOLS, R0,  # noqa: E402
                                        R1)


def _block_ids(n, n_blocks, seed):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, n), n_blocks - 1, replace=False))
    sizes = np.diff(np.concatenate([[0], cuts, [n]]))
    return np.repeat(np.arange(n_blocks), sizes)


def _catalogs(n=1024, n_blocks=16, r=8, bm=64, bn=64, seed=0):
    """tests/test_mesh_comms.py's blocked self-join catalog, lowered by
    the reference and by the port (the tiles must be equal)."""
    bids = _block_ids(n, n_blocks, seed)
    zeros = np.zeros(n, np.int64)
    jcat = jc.lower(jc.plan_to_job(j_plan_pair_range(
        j_compute_bdm(bids, zeros, n_blocks, 1), r)), bm, bn)
    tcat = tc.lower(tc.plan_to_job(plan_pair_range(
        compute_bdm(bids, zeros, n_blocks, 1), r)), bm, bn)
    np.testing.assert_array_equal(jcat.tiles, tcat.tiles)
    return jcat, tcat


def _cross_catalogs():
    """A two-source cross catalog (no band) and the same with a band on
    one tile, for the cross-mode rules."""
    return (jc.lower(jc.cross_job(512, 64, 4), 64, 64),
            tc.lower(tc.cross_job(512, 64, 4), 64, 64))


def _banded(cat):
    tiles = cat.tiles.copy()
    tiles[0, BAND] = 5
    return dataclasses.replace(cat, tiles=tiles)


def assert_plans_equal(jp, tp):
    for f in dataclasses.fields(jp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert (a is None) == (b is None), f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, (f.name, a, b)
    assert jp.buffer_rows == tp.buffer_rows
    assert jp.bytes_received_per_device() == tp.bytes_received_per_device()
    assert jp.summary() == tp.summary()


@pytest.mark.parametrize("n", [1, 2, 7, 8, 16, 64])
def test_default_group(n):
    assert tc.default_group(n) == jc.default_group(n)


@pytest.mark.parametrize("n_loc,halo", [(128, 300), (128, 128), (128, 5),
                                        (128, 0), (37, 1000)])
def test_halo_hops_and_bytes(n_loc, halo):
    assert tc.halo_hop_rows(n_loc, halo) == jc.halo_hop_rows(n_loc, halo)
    assert (tc.halo_bytes_per_device(n_loc, halo, 64)
            == jc.halo_bytes_per_device(n_loc, halo, 64))


@pytest.mark.parametrize("n_model", [1, 2, 4, 8])
def test_psum_bytes(n_model):
    assert (tc.psum_bytes_per_device(n_model, 10, 64, 64)
            == jc.psum_bytes_per_device(n_model, 10, 64, 64))


PLAN_CASES = [
    # (policy, n_rows, n_data, extra kwargs)
    ("flat", 1024, 8, {}),
    ("ring", 1024, 8, {}),
    ("hierarchical", 1024, 8, {}),
    ("hierarchical", 1024, 8, {"group": 4}),
    ("hierarchical", 1024, 16, {"group": 1}),
    ("ring", 1024, 1, {}),
    ("ring", 1024, 8, {"n_model": 2}),
    ("hierarchical", 1024, 4, {"n_model": 4}),
    ("ring", 1001, 8, {}),                      # rows not shard-divisible
    ("ring", 768, 8, {}),                       # n_loc 96, bm 64
    ("hierarchical", 768, 8, {}),
    ("ring", 1024, 8, {"pin_hops": 0}),         # pinned below the need
    ("ring", 1024, 8, {"pin_hops": 6}),         # over-gather
    ("hierarchical", 1024, 8, {"pin_inter_hops": 0}),
    ("hierarchical", 1024, 8, {"pin_inter_hops": 3}),
    ("ring", 2048, 16, {"itemsize": 2}),
]


@pytest.mark.parametrize("policy,n_rows,n_data,kw", PLAN_CASES,
                         ids=[f"{p}-{r}-{d}-{k}" for p, r, d, k in PLAN_CASES])
def test_plan_comms_self_join(policy, n_rows, n_data, kw):
    jcat, tcat = _catalogs()
    args = dict(policy=policy, feature_dim=64, **kw)
    assert_plans_equal(jc.plan_comms(jcat, n_rows, n_data, **args),
                       tc.plan_comms(tcat, n_rows, n_data, **args))


@pytest.mark.parametrize("policy", ["ring", "hierarchical"])
@pytest.mark.parametrize("banded", [False, True])
def test_plan_comms_cross_mode(policy, banded):
    jcat, tcat = _cross_catalogs()
    if banded:
        jcat, tcat = _banded(jcat), _banded(tcat)
    args = dict(policy=policy, feature_dim=64, self_join=False,
                pin_hops=0, pin_inter_hops=0)
    jp = jc.plan_comms(jcat, 512, 8, **args)
    tp = tc.plan_comms(tcat, 512, 8, **args)
    assert_plans_equal(jp, tp)
    assert (tp.fallback is not None) == banded


@pytest.mark.parametrize("bad", [dict(policy="mesh2d"),
                                 dict(policy="ring", n_model=3),
                                 dict(policy="hierarchical", group=3)])
def test_plan_comms_raises_alike(bad):
    jcat, tcat = _catalogs()
    kw = dict(feature_dim=64, **bad)
    with pytest.raises(ValueError) as je:
        jc.plan_comms(jcat, 1024, 8, **kw)
    with pytest.raises(ValueError) as te:
        tc.plan_comms(tcat, 1024, 8, **kw)
    assert str(je.value) == str(te.value)


@pytest.mark.parametrize("n_dev", [1, 4, 16, 64])
@pytest.mark.parametrize("self_join", [True, False])
def test_comms_volume(n_dev, self_join):
    jcat, tcat = _catalogs(n=4096, n_blocks=64)
    kw = dict(feature_dim=64, self_join=self_join)
    assert (tc.comms_volume(tcat, 4096, n_dev, **kw)
            == jc.comms_volume(jcat, 4096, n_dev, **kw))


@pytest.mark.parametrize("policy", ["ring", "hierarchical"])
@pytest.mark.parametrize("shift_b", [True, False])
def test_rewrite_tiles_local(policy, shift_b):
    """The planner's own placement, shard by shard, shifted to buffer
    coordinates (plus an all-zero padding row that must stay put)."""
    jcat, tcat = _catalogs()
    plan = tc.plan_comms(tcat, 1024, 8, policy=policy, feature_dim=64)
    counts = np.bincount(plan.device_of_tile, minlength=8)
    dev = np.zeros((8, counts.max() + 1, NCOLS), np.int32)
    for d in range(8):
        mine = tcat.tiles[plan.device_of_tile == d]
        dev[d, :mine.shape[0]] = mine
    got = tc.rewrite_tiles_local(dev, plan.base, 64, 64, shift_b=shift_b)
    want = jc.rewrite_tiles_local(dev, plan.base, 64, 64, shift_b=shift_b)
    np.testing.assert_array_equal(got, want)
    assert (got[:, -1] == 0).all()
    live = got[:, :, R1] > got[:, :, R0]
    assert (got[:, :, A_TILE][live] >= 0).all()


def test_rewrite_rejects_unaligned_origins_alike():
    tiles = np.zeros((2, 3, NCOLS), np.int32)
    for mod in (tc, jc):
        with pytest.raises(ValueError):
            mod.rewrite_tiles_local(tiles, np.array([100, 512]), 64, 64)

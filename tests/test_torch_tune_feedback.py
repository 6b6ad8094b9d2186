"""Tuning and feedback of the port against the JAX package, on the CPU:
``tile_class`` on real catalogs of every strategy, the EWMA and geometry
cost models after the same observations (and their JSON state round
trips), ``autotune`` reports on the same jobs, feedback-calibrated
``schedule_tiles``, and ``run_er(tune_tiles=True)``. Mirrors
tests/test_tile_geometry.py and tests/test_feedback_scheduling.py."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro import core as jcore  # noqa: E402
from repro.er import ERConfig as JERConfig, run_er as j_run_er  # noqa: E402
from repro.er import compiler as jc  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.er import ERConfig, run_er  # noqa: E402
from repro_torch.er import compiler as pc  # noqa: E402
from repro_torch.kernels import pair_sim  # noqa: E402
from torch_parity import keyless, skewed_corpus  # noqa: E402

STRATEGIES = ("basic", "block_split", "pair_range", "sorted_neighborhood")
SIZES = np.array([150, 37, 80, 1, 9, 300, 12, 64], np.int64)


def _jobs(pkg, cmod):
    """name -> MatchJob of ``pkg`` (repro.core or repro_torch.core)."""
    n = int(SIZES.sum())
    bdm = pkg.compute_bdm(np.repeat(np.arange(SIZES.size), SIZES),
                          np.zeros(n, np.int64), SIZES.size, 1)
    plans = {"basic": pkg.plan_basic(bdm, 6),
             "block_split": pkg.plan_block_split(bdm, 6),
             "pair_range": pkg.plan_pair_range(bdm, 6),
             "sorted_neighborhood": pkg.plan_sorted_neighborhood(n, 20, 6)}
    jobs = {k: cmod.plan_to_job(v) for k, v in plans.items()}
    jobs["cross"] = cmod.cross_job(n, 70, 4)
    return jobs


J_JOBS = _jobs(jcore, jc)
P_JOBS = _jobs(core, pc)
NAMES = sorted(P_JOBS)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("bm,bn", [(32, 32), (64, 128), (128, 128)])
def test_tile_class_equals_reference(name, bm, bn):
    jcat = jc.lower(J_JOBS[name], bm, bn)
    pcat = pc.lower(P_JOBS[name], bm, bn)
    np.testing.assert_array_equal(pcat.tiles, jcat.tiles)
    got = pc.tile_class(pcat)
    np.testing.assert_array_equal(got, jc.tile_class(jcat))
    assert ((got >= 0) & (got < pc.N_TILE_CLASSES)).all()
    assert pc.TILE_CLASS_NAMES == jc.TILE_CLASS_NAMES


def _observations(seed, n_dev, count):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        cost = rng.integers(0, 2000, pc.N_TILE_CLASSES).astype(np.float64)
        cost[rng.random(pc.N_TILE_CLASSES) < 0.4] = 0.0
        yield int(rng.integers(0, n_dev)), cost, float(rng.uniform(0, 5e-3))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ewma_state_equals_reference_after_the_same_observations(seed):
    jm, pm = jc.EwmaCostModel(3, alpha=0.4), pc.EwmaCostModel(3, alpha=0.4)
    for dev, cost, sec in _observations(seed, 3, 25):
        jm.observe(dev, cost, sec)
        pm.observe(dev, cost, sec)
    pm.reset_device(1)
    jm.reset_device(1)
    state = pm.to_state()
    assert state == jm.to_state()
    np.testing.assert_array_equal(pm.device_rates(), jm.device_rates())
    np.testing.assert_array_equal(pm.class_rates(), jm.class_rates())
    cost = np.array([10.0, 0.0, 5.0, 1.0])
    assert pm.predict(2, cost) == jm.predict(2, cost)
    # round trips, both ways across the packages (plain JSON data)
    back = pc.EwmaCostModel.from_state(jm.to_state())
    assert back.to_state() == state
    assert jc.EwmaCostModel.from_state(state).to_state() == state
    with pytest.raises(ValueError):
        pc.EwmaCostModel.from_state({**state, "version": 2})
    with pytest.raises(ValueError):
        pc.EwmaCostModel(0)
    with pytest.raises(ValueError):
        pc.EwmaCostModel(2, alpha=0.0)


def test_geometry_model_state_equals_reference():
    jm, pm = jc.GeometryCostModel(alpha=0.3), pc.GeometryCostModel(alpha=0.3)
    rng = np.random.default_rng(3)
    for _ in range(20):
        g = pair_sim.GEOMETRY_LATTICE[int(rng.integers(0, 16))]
        live, sec = float(rng.integers(0, 5000)), float(rng.uniform(0, 1))
        jm.observe(g, live, sec)
        pm.observe(g, live, sec)
    assert pm.to_state() == jm.to_state()
    assert pm.best() == jm.best()
    assert pm.best([(32, 32), (64, 64)]) == jm.best([(32, 32), (64, 64)])
    assert math.isnan(pc.GeometryCostModel().rate((32, 32)))
    back = pc.GeometryCostModel.from_state(jm.to_state())
    assert back.to_state() == pm.to_state()


def _score_fields(s):
    return (s.block_m, s.block_n, s.tiles, s.cells, s.live_pairs, s.waste,
            s.occupancy, s.model_cost)


@pytest.mark.parametrize("name", NAMES)
def test_autotune_at_capacity_zero_equals_reference(name):
    """At d = 256 and no capacity every lattice point fits both the TPU's
    VMEM budget and the H100's shared memory: the same pick, and the same
    table in the same order."""
    want = jc.autotune(J_JOBS[name], d=256)
    got = pc.autotune(P_JOBS[name], d=256)
    assert got.geometry == want.geometry and not got.measured
    assert [_score_fields(s) for s in got.scores] == \
        [_score_fields(s) for s in want.scores]


@pytest.mark.parametrize("name", ["pair_range", "sorted_neighborhood"])
def test_autotune_with_a_capacity_scores_shared_candidates_equally(name):
    """With a compaction capacity the TPU's VMEM filter drops the large
    geometries and the Hopper model drops none: each candidate both keep
    has the same waste, occupancy and model cost."""
    want = jc.autotune(J_JOBS[name], d=256, capacity=16_384)
    got = pc.autotune(P_JOBS[name], d=256, capacity=16_384)
    assert len(got.scores) == len(pair_sim.GEOMETRY_LATTICE)
    assert len(want.scores) < len(got.scores)
    mine = {s.geometry: _score_fields(s) for s in got.scores}
    for s in want.scores:
        assert mine[s.geometry] == _score_fields(s)


def test_autotune_with_measured_rates_equals_reference():
    jm, pm = jc.GeometryCostModel(), pc.GeometryCostModel()
    for g, sec in (((64, 64), 2e-3), ((128, 128), 5e-3), ((32, 32), 9e-3)):
        jm.observe(g, 10_000, sec)
        pm.observe(g, 10_000, sec)
    want = jc.autotune(J_JOBS["pair_range"], d=256, feedback=jm)
    got = pc.autotune(P_JOBS["pair_range"], d=256, feedback=pm)
    assert got.measured and want.measured
    assert got.geometry == want.geometry
    assert [(s.geometry, s.predicted_seconds) for s in got.scores] == \
        [(s.geometry, s.predicted_seconds) for s in want.scores]


def test_autotune_raises_when_nothing_runs_on_the_kernel():
    with pytest.raises(ValueError):
        pc.autotune(P_JOBS["basic"], lattice=((16, 16), (512, 512)))


def test_occupancy_waste_equals_enumerated_dead_cells():
    cat = pc.lower(P_JOBS["pair_range"], 64, 32)
    cells, live, waste = pc.catalog_occupancy(cat)
    ra, _ = pc.enumerate_catalog_pairs(cat)
    assert live == ra.size and waste == cells - ra.size
    assert (cells, live, waste) == jc.catalog_occupancy(
        jc.lower(J_JOBS["pair_range"], 64, 32))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n_dev", [1, 3])
def test_calibrated_schedule_equals_reference(name, n_dev):
    jm, pm = jc.EwmaCostModel(n_dev), pc.EwmaCostModel(n_dev)
    for dev, cost, sec in _observations(7, n_dev, 12):
        jm.observe(dev, cost, sec)
        pm.observe(dev, cost, sec)
    jcat = jc.lower(J_JOBS[name], 32, 32)
    pcat = pc.lower(P_JOBS[name], 32, 32)
    want = jc.schedule_tiles(jcat, n_dev=n_dev, feedback=jm)
    got = pc.schedule_tiles(pcat, n_dev=n_dev, feedback=pm)
    assert got.calibrated and want.calibrated
    for field in ("tile_cost", "tile_reducer", "reducer_device",
                  "reducer_load", "device_load", "healthy", "device_rate",
                  "predicted_s"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.stats() == want.stats()
    # calibration re-weights placement only: every tile is placed once
    assert int(got.reducer_load.sum()) == int(got.tile_cost.sum())
    # an unobserved model leaves the exact cost-LPT schedule alone
    plain = pc.schedule_tiles(pcat, n_dev=n_dev,
                              feedback=pc.EwmaCostModel(n_dev))
    assert not plain.calibrated
    np.testing.assert_array_equal(
        plain.tile_reducer, pc.schedule_tiles(pcat, n_dev=n_dev).tile_reducer)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_run_er_tune_tiles_equals_reference(strategy):
    titles, bid = keyless(*skewed_corpus())
    titles, bid = titles[:700], bid[:700]
    kw = dict(strategy=strategy, r=8, m=4, feature_dim=128, max_len=48,
              tune_tiles=True)
    want = j_run_er(titles, JERConfig(**kw), block_ids=bid)
    got = run_er(titles, ERConfig(**kw), block_ids=bid, device="cpu")
    assert got.matches == want.matches
    assert got.extra["tuned_geometry"] == want.extra["tuned_geometry"]
    assert got.extra["catalog_tiles"] == want.extra["catalog_tiles"]
    assert got.total_pairs == want.total_pairs

"""The port's fault-tolerant supervisor on the CPU, against the JAX
package: seeded fault scripts are the same scripts, and
``execute_supervised`` under them (kills, straggles, transient errors,
corrupted shards; with and without work stealing) returns the quiet match
set — the JAX package's — with the same deterministic report fields
(rounds, recovered and lost tiles, coverage, the final healthy mask; not
the wall-clock makespans or steal counts). Mirrors
tests/test_fault_recovery.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro import core as jcore  # noqa: E402
from repro.er import ERConfig as JERConfig, run_er as j_run_er  # noqa: E402
from repro.er import compiler as jc  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.er import ERConfig, make_products, run_er  # noqa: E402
from repro_torch.er import compiler as pc  # noqa: E402
from repro_torch.er.compiler import (FaultEvent, FaultInjector,  # noqa: E402
                                     FaultScript, NoHealthyDevicesError,
                                     RecoveryFailedError, execute,
                                     execute_supervised, shard_sane)

BM = BN = 32
THRESH = 0.4


def _feats(n, seed, dim=32):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(n, dim)).astype(np.float32)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


def _catalog(strategy, sizes, r, pkg=core, cmod=pc):
    """A plan over explicit block sizes (1 input partition), lowered by
    ``cmod`` (the port's compiler, or the JAX package's)."""
    sizes = np.asarray(sizes, np.int64)
    n = int(sizes.sum())
    if strategy == "sorted_neighborhood":
        plan = pkg.plan_sorted_neighborhood(n, w=5, r=r)
    else:
        bdm = pkg.compute_bdm(np.repeat(np.arange(sizes.size), sizes),
                              np.zeros(n, np.int64), sizes.size, 1)
        plan = {"basic": pkg.plan_basic, "block_split": pkg.plan_block_split,
                "pair_range": pkg.plan_pair_range}[strategy](bdm, r)
    return cmod.lower(cmod.plan_to_job(plan), BM, BN), n


def _pairs(ra, rb):
    return set(zip(np.asarray(ra).tolist(), np.asarray(rb).tolist()))


def _quiet(catalog, feats, feats_b=None):
    return _pairs(*execute(catalog, feats, feats_b, threshold=THRESH,
                           device="cpu"))


def _script_events(script):
    return [(e.kind, e.device, e.step, e.delay, e.sticky)
            for e in script.events]


@pytest.mark.parametrize("seed", [0, 3, 11, 42])
def test_random_scripts_equal_reference(seed):
    for kw in (dict(), dict(allow_revive=True, fatal_frac=0.5)):
        got = FaultScript.random(seed, 6, 12, **kw)
        want = jc.FaultScript.random(seed, 6, 12, **kw)
        assert _script_events(got) == _script_events(want)
        assert got.n_dev == want.n_dev
    inj, jinj = FaultInjector(got, seed=seed), jc.FaultInjector(want,
                                                               seed=seed)
    ra, rb = np.arange(20), np.arange(20)
    for a, b in zip(inj.corrupt_output(ra, rb, 20, 20),
                    jinj.corrupt_output(ra, rb, 20, 20)):
        np.testing.assert_array_equal(a, b)


SCRIPTS = {
    "kill": lambda n: (FaultEvent("kill", 1, 0),),
    "straggle": lambda n: (FaultEvent("straggle", 2, 1, delay=1e6),),
    "transient": lambda n: (FaultEvent("transient", 0, 0),
                            FaultEvent("transient", 3, 2)),
    "corrupt": lambda n: (FaultEvent("corrupt", 1, 0),
                          FaultEvent("corrupt", 2, 3)),
    "mixed": lambda n: (FaultEvent("kill", 0, 1), FaultEvent("corrupt", 2, 2),
                        FaultEvent("straggle", 3, 4, delay=1e6),
                        FaultEvent("transient", 1, 5)),
}


def _report_fields(rep):
    return (rep.rounds, rep.recovered_tiles, rep.lost_tiles, rep.coverage,
            rep.planned_cost, rep.scored_cost, rep.healthy.tolist(),
            [(r.round, r.device, r.tiles, r.cost, r.status)
             for r in rep.records])


@pytest.mark.parametrize("kind", sorted(SCRIPTS))
@pytest.mark.parametrize("strategy", ["block_split", "pair_range",
                                      "sorted_neighborhood"])
def test_seeded_scripts_recover_the_reference_match_set(kind, strategy):
    sizes = [90, 33, 12, 4, 51]
    cat, n = _catalog(strategy, sizes, r=8)
    jcat, _ = _catalog(strategy, sizes, r=8, pkg=jcore, cmod=jc)
    f = _feats(n, 1)
    events = SCRIPTS[kind](4)
    kw = dict(threshold=THRESH, n_dev=4, shard_deadline=60.0,
              max_retries=6, backoff=0.0)
    ra, rb, rep = execute_supervised(
        cat, f, injector=FaultInjector(FaultScript(events, 4)),
        device="cpu", **kw)
    ja, jb, jrep = jc.execute_supervised(
        jcat, f, injector=jc.FaultInjector(jc.FaultScript(
            tuple(jc.FaultEvent(e.kind, e.device, e.step, e.delay)
                  for e in events), 4)), **kw)
    assert _pairs(ra, rb) == _quiet(cat, f) == _pairs(ja, jb)
    assert rep.coverage == 1.0 and rep.lost_tiles == 0
    assert _report_fields(rep) == _report_fields(jrep)


@pytest.mark.parametrize("seed", [1, 5])
def test_work_stealing_under_a_sticky_straggler_keeps_the_match_set(seed):
    cat, n = _catalog("pair_range", [120, 60, 33, 9], r=12)
    f = _feats(n, seed)
    script = FaultScript((FaultEvent("straggle", 0, 0, delay=0.02,
                                     sticky=True),), 4)
    for steal in (None, 1.5):
        ra, rb, rep = execute_supervised(
            cat, f, threshold=THRESH, n_dev=4, max_retries=4, backoff=0.0,
            injector=FaultInjector(script), steal_factor=steal,
            steal_quantum=2, feedback=pc.EwmaCostModel(4), device="cpu")
        assert _pairs(ra, rb) == _quiet(cat, f)
        assert rep.coverage == 1.0 and rep.rounds == 1


def test_random_script_under_stealing_equals_reference_match_set():
    sizes = [80, 40, 17, 3]
    cat, n = _catalog("block_split", sizes, r=8)
    jcat, _ = _catalog("block_split", sizes, r=8, pkg=jcore, cmod=jc)
    f = _feats(n, 2)
    kw = dict(threshold=THRESH, n_dev=4, shard_deadline=60.0,
              max_retries=12, backoff=0.0, steal_factor=1.5)
    ra, rb, rep = execute_supervised(
        cat, f, injector=FaultInjector(FaultScript.random(
            7, 4, 8, straggle_delay=1e6)), device="cpu", **kw)
    ja, jb, jrep = jc.execute_supervised(
        jcat, f, injector=jc.FaultInjector(jc.FaultScript.random(
            7, 4, 8, straggle_delay=1e6)), **kw)
    assert _pairs(ra, rb) == _pairs(ja, jb) == _quiet(cat, f)
    assert rep.coverage == jrep.coverage == 1.0


def test_no_injector_equals_execute():
    cat, n = _catalog("pair_range", [60, 17, 5, 1, 40], r=8)
    f = _feats(n, 0)
    ra, rb, rep = execute_supervised(cat, f, threshold=THRESH, n_dev=4,
                                     device="cpu")
    assert _pairs(ra, rb) == _quiet(cat, f)
    assert rep.rounds == 1 and rep.retries == 0 and rep.coverage == 1.0


def test_survives_all_but_one_device():
    cat, n = _catalog("block_split", [90, 33, 12, 4], r=8)
    f = _feats(n, 1)
    script = FaultScript(tuple(FaultEvent("kill", d, 0) for d in range(3)),
                         n_dev=4)
    ra, rb, rep = execute_supervised(
        cat, f, threshold=THRESH, n_dev=4, max_retries=4, backoff=0.0,
        injector=FaultInjector(script), device="cpu")
    assert _pairs(ra, rb) == _quiet(cat, f)
    assert rep.healthy.tolist() == [False, False, False, True]


def test_all_devices_dead_raises_typed_error_or_degrades():
    cat, n = _catalog("basic", [50, 20], r=4)
    f = _feats(n, 2)
    script = FaultScript(tuple(FaultEvent("kill", d, 0) for d in range(3)),
                         n_dev=3)
    with pytest.raises(NoHealthyDevicesError):
        execute_supervised(cat, f, threshold=THRESH, n_dev=3, max_retries=4,
                           backoff=0.0, injector=FaultInjector(script),
                           device="cpu")
    ra, rb, rep = execute_supervised(
        cat, f, threshold=THRESH, n_dev=3, max_retries=4, backoff=0.0,
        partial=True, injector=FaultInjector(script), device="cpu")
    assert ra.size == 0 and rep.coverage == 0.0 and rep.lost_tiles > 0


def test_retry_exhaustion_is_bounded_and_typed():
    cat, n = _catalog("pair_range", [70, 30], r=4)
    f = _feats(n, 3)
    script = FaultScript(tuple(FaultEvent("corrupt", 0, 0)
                               for _ in range(50)), n_dev=1)
    with pytest.raises(RecoveryFailedError) as ei:
        execute_supervised(cat, f, threshold=THRESH, n_dev=1, max_retries=2,
                           backoff=0.0, injector=FaultInjector(script),
                           device="cpu")
    assert ei.value.report.retries == 2


def test_backoff_is_exponential_and_observed():
    cat, n = _catalog("pair_range", [80, 25], r=4)
    f = _feats(n, 4)
    script = FaultScript((FaultEvent("transient", 0, 0),
                          FaultEvent("transient", 0, 2),
                          FaultEvent("transient", 0, 4)), n_dev=2)
    slept = []
    ra, rb, rep = execute_supervised(
        cat, f, threshold=THRESH, n_dev=2, max_retries=6, backoff=0.01,
        backoff_factor=3.0, sleep=slept.append,
        injector=FaultInjector(script), device="cpu")
    assert _pairs(ra, rb) == _quiet(cat, f)
    assert slept == rep.backoffs and len(slept) >= 2
    for prev, nxt in zip(rep.backoffs, rep.backoffs[1:]):
        assert nxt == pytest.approx(prev * 3.0)


def test_merge_is_exactly_once_and_two_source_recovers():
    cat, n = _catalog("basic", [64, 64], r=4)
    f = _feats(n, 6)
    script = FaultScript((FaultEvent("corrupt", 0, 0),
                          FaultEvent("transient", 1, 0)), n_dev=2)
    ra, rb, _ = execute_supervised(
        cat, f, threshold=THRESH, n_dev=2, max_retries=4, backoff=0.0,
        injector=FaultInjector(script), device="cpu")
    pairs = np.stack([ra, rb], axis=1)
    assert np.unique(pairs, axis=0).shape[0] == pairs.shape[0]
    assert _pairs(ra, rb) == _quiet(cat, f)
    cross = pc.lower(pc.cross_job(130, 37, r=4), BM, BN)
    fa, fb = _feats(130, 7), _feats(37, 8)
    script = FaultScript((FaultEvent("kill", 0, 1),
                          FaultEvent("corrupt", 2, 2)), n_dev=3)
    ra, rb, rep = execute_supervised(
        cross, fa, fb, threshold=THRESH, n_dev=3, max_retries=4,
        backoff=0.0, injector=FaultInjector(script), device="cpu")
    assert _pairs(ra, rb) == _quiet(cross, fa, fb)
    assert rep.coverage == 1.0


def test_empty_catalog_and_shard_sane():
    cat, _ = _catalog("basic", [1], r=2)
    assert cat.num_tiles == 0
    ra, rb, rep = execute_supervised(cat, _feats(1, 9), threshold=THRESH,
                                     n_dev=2, device="cpu")
    assert ra.size == 0 and rep.coverage == 1.0
    ok_a, ok_b = np.array([0, 3]), np.array([1, 2])
    assert shard_sane(ok_a, ok_b, 4, 4)
    assert not shard_sane(np.array([4]), np.array([0]), 4, 4)
    assert not shard_sane(ok_a, ok_b[:1], 4, 4)
    inj = FaultInjector(FaultScript((), n_dev=1))
    assert not shard_sane(*inj.corrupt_output(ok_a, ok_b, 4, 4), 4, 4)


@pytest.mark.parametrize("strategy", ["block_split", "pair_range"])
def test_run_er_supervised_equals_reference(strategy):
    titles = list(make_products(250, seed=3).titles[:160])
    titles[::23] = ["" for _ in titles[::23]]       # match_⊥ runs too
    kw = dict(strategy=strategy, r=8, m=4, feature_dim=128, max_len=48,
              supervised_devices=4, max_retries=6, backoff_s=0.0,
              shard_deadline_s=60.0)
    events = ((FaultEvent("kill", 1, 0), FaultEvent("corrupt", 2, 3),
               FaultEvent("straggle", 3, 5, delay=1e6)))
    got = run_er(titles, ERConfig(**kw),
                 fault_injector=FaultInjector(FaultScript(events, 4)),
                 device="cpu")
    want = j_run_er(titles, JERConfig(**kw), fault_injector=jc.FaultInjector(
        jc.FaultScript(tuple(jc.FaultEvent(e.kind, e.device, e.step,
                                           e.delay) for e in events), 4)))
    assert got.matches == want.matches
    assert (got.attempts, got.recovered_tiles, got.coverage) == \
        (want.attempts, want.recovered_tiles, want.coverage)
    assert got.attempts > 1 and got.coverage == 1.0
    quiet = run_er(titles, ERConfig(**{**kw, "supervised_devices": 0}),
                   device="cpu")
    assert quiet.matches == got.matches
    stolen = run_er(titles, ERConfig(**{**kw, "steal_factor": 1.5}),
                    device="cpu")
    assert stolen.matches == got.matches and stolen.coverage == 1.0
    with pytest.raises(ValueError):
        run_er(titles, ERConfig(**{**kw, "executor": "reference"}),
               device="cpu")
    mesh = torch_parity.cpu_mesh(4)
    assert run_er(titles, ERConfig(**{**kw, "supervised_devices": 0}),
                  mesh=mesh, device="cpu").matches == got.matches
    with pytest.raises(ValueError, match="mesh"):   # not both at once
        run_er(titles, ERConfig(**kw), mesh=mesh, device="cpu")

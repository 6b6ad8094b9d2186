"""The port's resident ER service on the CPU: streaming ≡ batch against the
port's one-shot ``run_er`` (both executors, both two-source planners,
null keys on both sides, never-seen blocks, empty inputs), equality with
the JAX package's ``ERService`` on the same corpus and batches, graceful
degradation and the circuit breaker, the steady-state build/load counter
(and the lock that makes a racing first load build once), a warm start
from a JAX service's exported feedback state, and ``ERBatcher``'s exact
per-request demux and admission control. Mirrors
tests/test_service_stream.py, tests/test_service_degradation.py,
tests/test_service_recompile.py and tests/test_batcher.py."""
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro.er import ERService as JERService  # noqa: E402
from repro.er import ServiceConfig as JServiceConfig  # noqa: E402
from repro_torch.convert import service_config_from  # noqa: E402
from repro_torch.er import (AdmissionError, ERBatcher, ERConfig,  # noqa: E402
                            ERService, MatchResponse, ServiceConfig,
                            ServiceUnavailable, compile_counter,
                            cross_restrict, make_products, run_er)
from repro_torch.er.compiler import (FaultEvent, FaultInjector,  # noqa: E402
                                     FaultScript)
from repro_torch.kernels import build  # noqa: E402

FEAT = dict(feature_dim=128, max_len=48)
DS = make_products(250, seed=3)
CORPUS = list(DS.titles[:140])
QUERIES = list(DS.titles[140:170])


def _cfg(**kw):
    base = dict(r=8, m=4, query_buckets=(8, 32), tile_chunk=64, **FEAT)
    base.update(kw)
    return ServiceConfig(**base)


def _svc(corpus=CORPUS, **kw):
    return ERService(corpus, _cfg(**kw), device="cpu")


# ---------------------------------------------------------------------------
# Streaming ≡ batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workload():
    ds = make_products(520, seed=2)
    corpus = list(ds.titles[:440]) + ["", "   "]
    queries = (list(ds.titles[440:500])
               + ["", "@@@ never seen block 0001",
                  "@@@ never seen block 0001", ds.titles[3]])
    both = {ex: run_er(corpus + queries,
                       ERConfig(r=8, m=4, executor=ex, **FEAT),
                       device="cpu")
            for ex in ("catalog", "reference")}
    assert both["catalog"].matches == both["reference"].matches
    return corpus, queries, cross_restrict(both["catalog"].matches,
                                           len(corpus))


def _stream(service, queries, sizes):
    got, off = set(), 0
    for sz in sizes:
        for a, b in service.match(queries[off:off + sz]):
            got.add((a, b + off))
        off += sz
    assert off == len(queries)
    return got


@pytest.mark.parametrize("strategy", ("pair_range", "block_split"))
def test_stream_equals_batch_over_splits(workload, strategy):
    corpus, queries, want = workload
    cfg = _cfg(strategy=strategy, query_buckets=(8, 32, 64))
    n = len(queries)
    for sizes in ([n], [1] * 9 + [n - 9], [5, 1, 17, 40, n - 63]):
        got = _stream(ERService(corpus, cfg, device="cpu"), queries, sizes)
        assert got == want


def test_stream_order_invariant_and_oversized_batch(workload):
    corpus, queries, want = workload
    perm = np.random.default_rng(7).permutation(len(queries))
    svc = ERService(corpus, _cfg(query_buckets=(8, 32, 64)), device="cpu")
    got = _stream(svc, [queries[int(i)] for i in perm],
                  [13, 29, 7, len(queries) - 49])
    assert {(a, int(perm[b])) for a, b in got} == want
    small = ERService(corpus, _cfg(query_buckets=(8, 16)), device="cpu")
    assert small.match(queries) == want       # len >> top bucket (16)
    assert small.stats["batches"] == -(-len(queries) // 16)


def test_never_seen_blocks_grow_bdm_and_empty_inputs(workload):
    corpus, _, _ = workload
    svc = ERService(corpus, _cfg(), device="cpu")
    b0 = svc.bdm.shape[0]
    svc.match(["@@@ never seen block 0001", "zzq another new one"])
    assert svc.bdm.shape[0] >= b0 + 1
    assert int(svc.bdm[b0:].sum()) == 0
    assert int(svc.traffic_bdm.sum()) == 2
    assert _svc(["abc one", "abc two"]).match([]) == set()
    empty = _svc([])
    assert empty.match(["abc one"]) == set()
    assert empty.warmup() == 0


@pytest.mark.parametrize("strategy", ("pair_range", "block_split"))
def test_service_equals_reference_service(workload, strategy):
    corpus, queries, _ = workload
    jcfg = JServiceConfig(r=8, m=4, strategy=strategy,
                          query_buckets=(8, 32, 64), tile_chunk=64, **FEAT)
    ref = JERService(corpus, jcfg)
    svc = ERService(corpus, service_config_from(jcfg), device="cpu")
    for lo, hi in ((0, 5), (5, 6), (6, 40), (40, len(queries))):
        assert set(svc.match(queries[lo:hi])) == set(
            ref.match(queries[lo:hi]))
    for key in ("batches", "queries", "planned_pairs", "matches",
                "bucket_hits"):
        assert svc.stats[key] == ref.stats[key], key
    np.testing.assert_array_equal(svc.traffic_bdm, ref.traffic_bdm)
    np.testing.assert_array_equal(svc.bdm, ref.bdm)


def test_config_mapping_and_refusals():
    for jname, pname in (("xla", "torch"), ("interpret", "torch"),
                         ("pallas", "cuda"), ("auto", "auto")):
        cfg = service_config_from(JServiceConfig(kernel_impl=jname))
        assert cfg.kernel_impl == pname
    with pytest.raises(ValueError):            # the JAX names are refused
        ERService(CORPUS[:10], _cfg(kernel_impl="xla"), device="cpu")
    with pytest.raises(ValueError):            # a card route without one
        ERService(CORPUS[:10], _cfg(kernel_impl="cuda"), device="cpu")
    with pytest.raises(ValueError):
        ERService(CORPUS[:10], _cfg(comms="bogus"), device="cpu")
    mesh = torch_parity.cpu_mesh(2)            # the sharded index serves
    sharded = ERService(CORPUS, _cfg(), mesh=mesh, device="cpu")
    assert set(sharded.match(QUERIES)) == set(_svc().match(QUERIES))
    with pytest.raises(ValueError):            # supervised refuses a mesh
        ERService(CORPUS[:10], _cfg(exec_devices=2), mesh=mesh,
                  device="cpu")
    # comms is ignored without a mesh, as in the JAX package
    ring = ERService(CORPUS, _cfg(comms="ring"), device="cpu")
    assert set(ring.match(QUERIES[:6])) == set(_svc().match(QUERIES[:6]))


# ---------------------------------------------------------------------------
# Degradation and the circuit breaker
# ---------------------------------------------------------------------------

_QUIET = {}


def _answer(titles):
    key = tuple(titles)
    if key not in _QUIET:
        if "svc" not in _QUIET:
            _QUIET["svc"] = _svc()
        _QUIET[key] = set(_QUIET["svc"].match(list(titles)))
    return _QUIET[key]


def test_supervised_quiet_path_equals_unsupervised():
    svc = _svc(exec_devices=4)
    for batch in (QUERIES[:6], QUERIES[6:14], QUERIES[14:22]):
        resp = svc.match(batch)
        assert isinstance(resp, MatchResponse) and isinstance(resp, set)
        assert set(resp) == _answer(batch)
        assert resp.coverage == 1.0 and resp.attempts == 1
    assert svc.stats["retries"] == 0


def test_chaos_kills_recover_to_exact_match_set():
    svc = _svc(exec_devices=4, backoff_s=0.0, breaker_threshold=2,
               breaker_cooldown_s=1e9)
    svc.set_fault_injector(FaultInjector(FaultScript((
        FaultEvent("kill", 1, 0), FaultEvent("corrupt", 2, 2),
        FaultEvent("transient", 3, 5), FaultEvent("kill", 2, 7)), 4)))
    for batch in (QUERIES[:8], QUERIES[8:16], QUERIES[16:24], QUERIES[:8]):
        resp = svc.match(batch)
        assert set(resp) == _answer(batch)
        assert resp.coverage == 1.0 and not resp.degraded
    assert svc.stats["retries"] > 0 and svc.stats["recovered_tiles"] > 0
    assert svc.stats["breaker_evictions"] >= 1


def test_breaker_opens_then_service_unavailable():
    svc = _svc(exec_devices=2, backoff_s=0.0, breaker_threshold=1,
               breaker_cooldown_s=1e9)
    svc.set_fault_injector(FaultInjector(FaultScript((
        FaultEvent("kill", 0, 0), FaultEvent("kill", 1, 0)), 2)))
    resp = svc.match(QUERIES[:6])
    assert resp.degraded and resp.coverage < 1.0 and len(resp) == 0
    assert svc.stats["breaker_evictions"] == 2
    with pytest.raises(ServiceUnavailable) as ei:
        svc.match(QUERIES[:6])
    assert 0 < ei.value.retry_after_s <= 1e9
    dead = _svc(exec_devices=2, backoff_s=0.0, partial_results=False)
    dead.set_fault_injector(FaultInjector(FaultScript((
        FaultEvent("kill", 0, 0), FaultEvent("kill", 1, 0)), 2)))
    with pytest.raises(ServiceUnavailable):
        dead.match(QUERIES[:6])


def test_breaker_probe_readmits_after_revive():
    svc = _svc(exec_devices=2, backoff_s=0.0, breaker_threshold=1,
               breaker_cooldown_s=0.0, feedback_scheduling=True)
    svc.set_fault_injector(FaultInjector(FaultScript((
        FaultEvent("kill", 1, 0), FaultEvent("revive", 1, 10)), 2)))
    for _ in range(8):
        assert set(svc.match(QUERIES[:6])) == _answer(QUERIES[:6])
    assert svc.stats["breaker_evictions"] >= 1
    assert svc.stats["breaker_readmissions"] >= 1
    assert not svc._breaker_open


def test_deadline_and_retry_exhaustion_degrade_to_partial():
    svc = _svc(exec_devices=2, request_deadline_s=0.0)
    resp = svc.match(QUERIES[:6])
    assert resp.degraded and resp.coverage < 1.0 and len(resp) == 0
    assert svc.stats["degraded"] == 1
    svc = _svc(exec_devices=1, max_retries=1, backoff_s=0.0)
    svc.set_fault_injector(FaultInjector(FaultScript(tuple(
        FaultEvent("corrupt", 0, 0) for _ in range(100)), 1)))
    resp = svc.match(QUERIES[:6])
    assert resp.degraded and resp.coverage < 1.0 and resp.attempts == 2


def test_concurrent_requests_equal_sequential_exactly():
    batches = [QUERIES[:8], QUERIES[8:16], QUERIES[16:24], QUERIES[24:30]]
    want = [_answer(b) for b in batches]
    svc = _svc(exec_devices=2)
    errors = []

    def worker(idx):
        try:
            for _ in range(3):
                for batch, w in zip(batches[idx::2], want[idx::2]):
                    resp = svc.match(batch)
                    assert set(resp) == w and resp.coverage == 1.0
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    assert svc.stats["batches"] == 2 * 3 * 2


# ---------------------------------------------------------------------------
# The build/load counter and the build lock
# ---------------------------------------------------------------------------

def test_zero_steady_state_builds_and_loads():
    ds = make_products(450, seed=3)
    svc = ERService(list(ds.titles[:400]) + [""],
                    _cfg(query_buckets=(8, 32, 64)), device="cpu")
    svc.warmup()
    assert int(svc.traffic_bdm.sum()) == 0 and svc.stats["batches"] == 0
    rng = np.random.default_rng(1)
    pool = list(ds.titles[400:]) + ["", "@@@ new block title 01"]
    with compile_counter() as steady:
        for _ in range(30):
            sz = int(rng.integers(1, 65))
            svc.match([pool[int(rng.integers(0, len(pool)))]
                       for _ in range(sz)])
    assert steady.count == 0
    hits = svc.stats["bucket_hits"]
    assert sum(hits.values()) == 30
    assert sum(1 for v in hits.values() if v > 0) >= 2


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """A stand-in nvcc (writes its -o target, counts its runs, sleeps a
    little) and a stand-in ctypes loader, so build.py's real build and
    load path runs here without a CUDA toolkit."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    runs = tmp_path / "nvcc_runs"
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import pathlib, sys, time\n"
        "time.sleep(0.3)\n"
        f"open({str(runs)!r}, 'a').write('run\\n')\n"
        "pathlib.Path(sys.argv[sys.argv.index('-o') + 1]).write_bytes(b'')\n"
        "print('ptxas info    : stand-in')\n")
    os.chmod(nvcc, 0o755)
    loads = []

    def cdll(path):
        loads.append(path)
        time.sleep(0.05)
        return object()

    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_LOG", {})
    monkeypatch.setattr(build.ctypes, "CDLL", cdll)
    return lambda: (runs.read_text().count("run") if runs.exists() else 0,
                    len(loads))


def test_counter_counts_a_forced_build_and_load(fake_toolchain):
    c = compile_counter()
    with c:
        build.load("pair_sim")
        assert c.count == 2                    # one build, one load
        with c:                                # re-entrant: no reset
            assert c.count == 2
        build.load("pair_sim")                 # loaded: no event
        assert c.count == 2
    assert fake_toolchain() == (1, 1)
    build._LIBS.clear()
    build.load("pair_sim")                     # outside every counter
    assert c.count == 2
    with compile_counter() as again:           # built: a load only
        build._LIBS.clear()
        build.load("pair_sim")
    assert again.count == 1


def test_racing_first_loads_build_and_load_once(fake_toolchain):
    """Two threads race the first launch's load: the lock makes one of
    them build and load while the other waits and takes the same
    library."""
    barrier = threading.Barrier(2)
    got, errors = [], []

    def first_launch():
        try:
            barrier.wait()
            got.append(build.load("pair_sim"))
        except BaseException as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with compile_counter() as c:
            threads = [threading.Thread(target=first_launch)
                       for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert fake_toolchain() == (1, 1)
    assert got[0] is got[1]
    assert c.count == 2


def test_concurrent_counters_each_see_a_build():
    n = 3
    barrier = threading.Barrier(n)
    seen, errors = [], []

    def worker():
        try:
            barrier.wait()
            with compile_counter() as c:
                build._emit("build", "x")
                time.sleep(0.01)
            seen.append(c.count)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and len(seen) == n and min(seen) >= 1
    assert not build._LISTENERS                # the last exit unregistered


# ---------------------------------------------------------------------------
# Warm start from a JAX service's exported feedback state
# ---------------------------------------------------------------------------

def test_warm_start_from_reference_feedback_state():
    titles = list(make_products(300, seed=3).titles)
    kw = dict(feature_dim=64, max_len=48, r=8, m=4, query_buckets=(8,),
              tile_chunk=64, autotune_tiles=True,
              autotune_lattice=((32, 32), (64, 64)), exec_devices=2,
              feedback_scheduling=True)
    ref = JERService(titles, JServiceConfig(**kw))
    ref.warmup()
    ref.match(titles[:8])                      # trains the EWMA too
    state = ref.export_feedback_state()
    assert state["geometry"]["rates"] and state["ewma"]["observations"]
    svc = ERService(titles, service_config_from(JServiceConfig(
        **kw, feedback_state=state)), device="cpu")
    assert svc.feedback.to_state() == state["ewma"]
    svc.warmup()                               # skips the sweep: pins
    assert svc.tile_geometry == ref.tile_geometry == tuple(
        state["geometry_pinned"])
    assert svc.geometry_feedback.to_state() == state["geometry"]
    assert svc.tune_report.geometry == ref.tune_report.geometry
    assert set(svc.match(titles[:8])) == set(ref.match(titles[:8]))
    mine = svc.export_feedback_state()
    assert mine["geometry_pinned"] == state["geometry_pinned"]


# ---------------------------------------------------------------------------
# ERBatcher: exact demux, flush policy, admission
# ---------------------------------------------------------------------------

def test_super_batched_results_equal_sequential():
    svc = _svc()
    batches = [QUERIES[:5], QUERIES[5:9], QUERIES[9:16], QUERIES[16:24],
               QUERIES[24:30], QUERIES[:3]]
    with ERBatcher(svc, max_delay_s=0.2) as b:
        futs = [b.submit(q) for q in batches]
        for fut, q in zip(futs, batches):
            resp = fut.result(timeout=120)
            assert isinstance(resp, MatchResponse)
            assert set(resp) == _answer(q)
    assert b.stats["requests"] == len(batches)
    assert 1 <= b.stats["super_batches"] < len(batches)


def test_flush_on_full_and_on_deadline():
    svc = _svc()
    with ERBatcher(svc, max_delay_s=60.0, max_batch=16) as b:
        futs = [b.submit(QUERIES[i * 4:(i + 1) * 4]) for i in range(4)]
        for i, fut in enumerate(futs):
            assert set(fut.result(timeout=120)) == _answer(
                QUERIES[i * 4:(i + 1) * 4])
        assert (b.stats["flush_full"], b.stats["flush_deadline"],
                b.stats["super_batches"], b.stats["max_fill"]) == \
            (1, 0, 1, 16)
    with ERBatcher(svc, max_delay_s=0.05, max_batch=32) as b:
        t0 = time.monotonic()
        fut = b.submit(QUERIES[:5])
        assert set(fut.result(timeout=120)) == _answer(QUERIES[:5])
        assert time.monotonic() - t0 >= 0.03
        assert b.stats["flush_deadline"] == 1 and b.stats["flush_full"] == 0


def test_oversized_request_closed_batcher_and_empty_request():
    svc = _svc(query_buckets=(8, 16))
    big = list(DS.titles[140:230])
    oracle = _svc(query_buckets=(8, 16))
    with ERBatcher(svc, max_delay_s=0.005) as b:
        fut = b.submit(big)
        small = b.submit(QUERIES[:4])
        assert set(fut.result(timeout=240)) == set(oracle.match(big))
        assert set(small.result(timeout=240)) == _answer(QUERIES[:4])
        assert b.submit([]).result(timeout=5) == set()
        assert b.flush(timeout=30)
    with pytest.raises(RuntimeError):
        b.submit(QUERIES[:2])
    b.close()                                  # idempotent


def test_interleaved_submissions_match_sequential_sweep():
    svc = _svc()
    rng = np.random.default_rng(11)
    with ERBatcher(svc, max_delay_s=0.01) as b:
        for _ in range(3):
            cuts = sorted(rng.choice(np.arange(1, len(QUERIES)),
                                     size=int(rng.integers(1, 6)),
                                     replace=False).tolist())
            bounds = [0] + cuts + [len(QUERIES)]
            batches = [QUERIES[lo:hi] for lo, hi in zip(bounds, bounds[1:])]
            staggers = rng.uniform(0.0, 0.01, len(batches))
            results = [None] * len(batches)

            def worker(i):
                time.sleep(float(staggers[i]))
                results[i] = b.submit(batches[i]).result(timeout=240)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(len(batches))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=240)
                assert not t.is_alive()
            for got, q in zip(results, batches):
                assert set(got) == _answer(q)


def test_tenant_admission_isolates_hot_tenant():
    svc = _svc()
    with ERBatcher(svc, max_delay_s=0.01, tenant_rate=40.0,
                   tenant_burst=8.0) as b:
        hot = [b.submit(QUERIES[:4], tenant="hot"),
               b.submit(QUERIES[4:8], tenant="hot")]
        with pytest.raises(AdmissionError) as ei:
            b.submit(QUERIES[8:12], tenant="hot")
        assert ei.value.tenant == "hot" and ei.value.retry_after_s > 0.0
        cool = b.submit(QUERIES[8:12], tenant="cool")
        assert set(cool.result(timeout=120)) == _answer(QUERIES[8:12])
        for fut, q in zip(hot, [QUERIES[:4], QUERIES[4:8]]):
            assert set(fut.result(timeout=120)) == _answer(q)
        assert b.stats["rejected"] == 1
        time.sleep(ei.value.retry_after_s + 0.05)
        ok = b.submit(QUERIES[8:12], tenant="hot")
        assert set(ok.result(timeout=120)) == _answer(QUERIES[8:12])


def test_super_batched_serving_builds_and_loads_nothing():
    svc = _svc()
    svc.warmup()
    with compile_counter() as cc:
        with ERBatcher(svc, max_delay_s=0.005) as b:
            futs = [b.submit(QUERIES[(i % 3) * 7:(i % 3) * 7 + 7])
                    for i in range(9)]
            for fut, i in zip(futs, range(9)):
                assert set(fut.result(timeout=240)) == _answer(
                    QUERIES[(i % 3) * 7:(i % 3) * 7 + 7])
    assert cc.count == 0

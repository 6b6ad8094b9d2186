"""The port's sharded-index ER service (``ERService(mesh=...)``) on 8
logical CPU shards. Mirrors tests/test_distributed_service.py: streaming
≡ batch against ``cross_restrict`` of a one-shot ``run_er`` over corpus
++ queries — the port's and the JAX package's — for the flat, ring and
hierarchical corpus gathers; zero builds or loads in steady state; the
reducer → device routing of the tile shards; the one-shot two-source
matcher on a pre-sharded corpus; and the residency row multiple under a
comms policy with the autotuner's lattice."""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.er import ERConfig as JERConfig  # noqa: E402
from repro.er import run_er as j_run_er  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.core import compute_bdm  # noqa: E402
from repro_torch.core.two_source import (TwoSourceBDM,  # noqa: E402
                                         plan_pair_range_2src)
from repro_torch.er import (ERConfig, ERService, ServiceConfig,  # noqa: E402
                            compile_counter, cross_restrict, make_products,
                            run_er, stage1_stats)
from repro_torch.er.compiler import (FaultEvent, FaultInjector,  # noqa: E402
                                     FaultScript)
from repro_torch.er.distributed import (device_assignment,  # noqa: E402
                                        match_catalog_2src_dist,
                                        plan_tiles_for_devices)
from repro_torch.er.executor import (RED, catalog_for_cross,  # noqa: E402
                                     catalog_for_two_source)
from repro_torch.er.pipeline import featurize  # noqa: E402

FEAT = dict(feature_dim=128, max_len=48)
DS = make_products(600, seed=5)
CORPUS = list(DS.titles[:500]) + [""]
QUERIES = list(DS.titles[500:560]) + ["", "@@@ fresh block"]


def _cfg(**kw):
    return ServiceConfig(r=16, m=8, query_buckets=(8, 32, 64), tile_chunk=64,
                         **FEAT, **kw)


@pytest.fixture(scope="module")
def want():
    """The cross matches of a one-shot run over corpus ++ queries: the
    port's (CPU) and the JAX package's must agree."""
    cfg = dict(r=16, m=8, **FEAT)
    port = run_er(CORPUS + QUERIES, ERConfig(**cfg), device="cpu")
    ref = j_run_er(CORPUS + QUERIES, JERConfig(**cfg))
    assert port.matches == ref.matches
    out = cross_restrict(port.matches, len(CORPUS))
    assert out
    return out


@pytest.mark.parametrize("comms", ["flat", "ring", "hierarchical"])
def test_sharded_stream_equals_batch(want, comms):
    svc = ERService(CORPUS, _cfg(comms=comms), mesh=tp.cpu_mesh(8),
                    device="cpu")
    svc.warmup()
    before = dict(stage1_stats["interconnect"])
    got, off = set(), 0
    for sz in (9, 33, 13, 7):
        for a, b in svc.match(QUERIES[off:off + sz]):
            got.add((a, b + off))
        off += sz
    assert off == len(QUERIES)
    assert got == want
    moved = {k: stage1_stats["interconnect"][k] - before[k] for k in before}
    if comms == "ring":          # pinned at zero hops: keyed jobs gather
        assert moved["ring_bytes"] == 0            # nothing
    if comms == "hierarchical":  # the group panel (g − 1 intra hops)
        assert moved["hier_intra_bytes"] > 0 and not moved["hier_inter_bytes"]
    assert moved["flat_bytes"] > 0               # the null-key jobs
    # zero builds or loads in steady state
    rng = np.random.default_rng(0)
    with compile_counter() as steady:
        for _ in range(6):
            sz = int(rng.integers(1, 65))
            svc.match([QUERIES[int(rng.integers(0, len(QUERIES)))]
                       for _ in range(sz)])
    assert steady.count == 0


def test_comms_residency_multiple_with_the_lattice(want):
    """Under a comms policy the corpus pads to shards × lcm of every
    geometry the service can pin, so a re-pin never degrades a plan."""
    lattice = ((32, 32), (64, 64))
    svc = ERService(CORPUS, _cfg(comms="ring", autotune_tiles=True,
                                 autotune_lattice=lattice),
                    mesh=tp.cpu_mesh(4), device="cpu")
    assert svc._row_mult == 4 * int(np.lcm.reduce([128, 32, 64]))
    assert svc._feats_keyed.shape[0] % svc._row_mult == 0
    svc.warmup()
    assert svc.tile_geometry in lattice
    got = set()
    for lo in range(0, len(QUERIES), 31):
        got |= {(a, b + lo) for a, b in svc.match(QUERIES[lo:lo + 31])}
    assert got == want


def test_reducer_to_device_routing():
    qb = np.asarray([0, 0, 1, 2] * 4)
    bdm2 = TwoSourceBDM(
        bdm_r=compute_bdm(np.arange(16) % 3, np.zeros(16, np.int64), 3, 1),
        bdm_s=compute_bdm(qb, np.zeros_like(qb), 3, 1))
    cat = catalog_for_two_source(plan_pair_range_2src(bdm2, 16), 16, 16)
    tiles_dev = plan_tiles_for_devices(cat, 8)
    dev_of = device_assignment(16, 8)
    for d in range(8):
        live = tiles_dev[d][tiles_dev[d][:, 3] > 0]      # R1 > 0: real
        assert live.size and all(dev_of[red] == d
                                 for red in live[:, RED].tolist())


def test_one_shot_2src_on_a_sharded_corpus():
    cfg = _cfg()
    _, _, cf = featurize(CORPUS[:64], cfg)       # 64 rows: 8 per shard
    _, _, qf = featurize(QUERIES[:16], cfg)
    mesh = tp.cpu_mesh(8)
    cf_sharded = sharding.shard_rows(cf, mesh.grid("data"))
    cross = catalog_for_cross(64, 16, r=16, block_m=16, block_n=16)
    ca, cb = match_catalog_2src_dist(cf_sharded, qf, cross, mesh,
                                     threshold=0.55, chunk_tiles=32)
    wa, wb = np.nonzero(cf @ qf.T >= np.float32(0.55))
    assert tp.pair_set(ca, cb) == tp.pair_set(wa, wb) and ca.size


def test_mesh_service_checks():
    mesh = tp.cpu_mesh(2)
    card_mesh = sharding.make_er_mesh(2, devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="device type"):
        ERService(CORPUS[:40], _cfg(), mesh=card_mesh, device="cpu")
    with pytest.raises(ValueError, match="mesh=None"):
        ERService(CORPUS[:40], _cfg(exec_devices=2), mesh=mesh, device="cpu")
    svc = ERService(CORPUS[:40], _cfg(), mesh=mesh, device="cpu")
    # A sharded-index service takes a fault injector, as the JAX
    # package's does (its answer under a script: the test below).
    injector = FaultInjector(FaultScript.random(0, 1, 1))
    svc.set_fault_injector(injector)
    assert svc.fault_injector is injector and svc._use_supervisor


FAULT_BATCHES = [QUERIES[:31], QUERIES[31:]]
FAULT_EVENTS = (("transient", 0, 0), ("corrupt", 0, 3), ("transient", 0, 5))

JAX_FAULT_SERVICE = f"""
import sys
import jax, numpy as np
from repro.er import ERService, ServiceConfig, make_products
from repro.er.compiler import FaultEvent, FaultInjector, FaultScript
try:
    mesh = jax.make_mesh((4,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
except AttributeError:
    mesh = jax.make_mesh((4,), ("data",))
ds = make_products(600, seed=5)
corpus = list(ds.titles[:500]) + [""]
queries = list(ds.titles[500:560]) + ["", "@@@ fresh block"]
batches = [queries[:31], queries[31:]]
cfg = ServiceConfig(r=16, m=8, query_buckets=(8, 32, 64), tile_chunk=64,
                    feature_dim=128, max_len=48, backoff_s=0.0)
svc = ERService(corpus, cfg, mesh=mesh)
svc.warmup()
svc.set_fault_injector(FaultInjector(FaultScript(events=tuple(
    FaultEvent(k, d, s) for k, d, s in {FAULT_EVENTS!r}), n_dev=1)))
out = {{}}
for i, b in enumerate(batches):
    resp = svc.match(b)
    out[f"pairs_{{i}}"] = np.array(sorted(resp), np.int64).reshape(-1, 2)
    out[f"meta_{{i}}"] = np.array([resp.attempts, resp.recovered_tiles,
                                  resp.coverage == 1.0])
out["stats"] = np.array([svc.stats["retries"], svc.stats["recovered_tiles"],
                         svc.stats["degraded"]])
np.savez(sys.argv[1], **out)
"""


def test_sharded_service_under_a_fault_script_equals_reference(tmp_path):
    """F3: a 4-shard CPU mesh service under a FaultScript gives the JAX
    mesh service's answer under the same script — the match set, the
    supervisor's rounds and recovered tiles per batch, and the retries —
    and the failure-free service's match set."""
    ref = tp.jax_mesh_reference(JAX_FAULT_SERVICE, tmp_path / "ref.npz")
    cfg = _cfg(backoff_s=0.0)
    quiet = ERService(CORPUS, cfg, device="cpu")
    svc = ERService(CORPUS, cfg, mesh=tp.cpu_mesh(4), device="cpu")
    svc.warmup()
    svc.set_fault_injector(FaultInjector(FaultScript(events=tuple(
        FaultEvent(k, d, s) for k, d, s in FAULT_EVENTS), n_dev=1)))
    for i, batch in enumerate(FAULT_BATCHES):
        resp = svc.match(batch)
        assert set(resp) == {tuple(p) for p in ref[f"pairs_{i}"].tolist()}
        assert set(resp) == set(quiet.match(batch))
        assert [resp.attempts, resp.recovered_tiles,
                resp.coverage == 1.0] == ref[f"meta_{i}"].tolist()
    assert [svc.stats["retries"], svc.stats["recovered_tiles"],
            svc.stats["degraded"]] == ref["stats"].tolist()
    assert svc.stats["retries"] >= 2 and svc.stats["recovered_tiles"] > 0


def test_sharded_service_gathers_the_corpus_once():
    """Under an injector the mesh service gathers each sharded corpus
    matrix onto its device on the first request only, and drops the
    copies when the injector is cleared."""
    svc = ERService(CORPUS, _cfg(backoff_s=0.0), mesh=tp.cpu_mesh(4),
                    device="cpu")
    svc.warmup()
    gathered = []
    gather = svc._gather
    svc._gather = lambda feats: gathered.append(feats) or gather(feats)
    svc.set_fault_injector(FaultInjector(FaultScript(events=(), n_dev=1)))
    first = set(svc.match(FAULT_BATCHES[0]))
    n_first = len(gathered)
    assert n_first
    assert set(svc.match(FAULT_BATCHES[0])) == first
    assert len(gathered) == n_first          # the same request: no gather
    svc.match(FAULT_BATCHES[1])
    # no matrix is gathered twice
    assert len({id(f) for f in gathered}) == len(gathered)
    svc.set_fault_injector(None)
    assert not svc._gathered

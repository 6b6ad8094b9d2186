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
from repro_torch.er.compiler import FaultInjector, FaultScript  # noqa: E402
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
    with pytest.raises(ValueError, match="fault injector"):
        svc.set_fault_injector(FaultInjector(FaultScript.random(0, 2, 1)))

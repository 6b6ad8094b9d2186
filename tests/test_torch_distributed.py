"""The port's ``er/distributed.py`` and ``run_er(mesh=...)`` on logical
CPU shards, against the JAX package on simulated host devices.

One subprocess per module runs the reference on the inputs of
tests/test_distributed_er.py and tests/test_distributed_sn.py (1,016
product titles over 8 devices) and saves its outputs: the sharded BDM,
the catalog executors' survivors (with and without a schedule, self-join and
two-source), RepSN's survivors at a one-hop and a multi-hop window and
the brute-force SN oracle, and ``run_er(mesh=...)``'s matches and
``comms_fallback`` for every strategy, comms policy and a (4, 2) data ×
model mesh. The port runs each entry point on the same inputs. The
legacy executors are in tests/test_torch_distributed_legacy.py.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.er.distributed import (  # noqa: E402
    sn_replication_volume as j_sn_replication_volume)
from repro_torch.core import (blocked_layout, compute_bdm,  # noqa: E402
                              entity_indices, plan_basic, plan_block_split,
                              plan_pair_range)
from repro_torch.er import (ERConfig, make_products, prefix_block_ids,  # noqa: E402
                            run_er, sn_sort_order)
from repro_torch import sharding  # noqa: E402
from repro_torch.er import distributed as dist  # noqa: E402
from repro_torch.er.compiler import (lower, plan_to_job,  # noqa: E402
                                     schedule_tiles, verify_pairs)
from repro_torch.er.encode import encode_titles, ngram_features  # noqa: E402
from repro_torch.er.executor import catalog_for_cross  # noqa: E402
from repro_torch.er.pipeline import featurize  # noqa: E402

N_DEV, DIM, MAXLEN = 8, 128, 48
STRATEGIES = ("basic", "block_split", "pair_range", "sorted_neighborhood")
# run_er(mesh=...) cases: (strategy, n_data, n_model, comms)
RUNS = ([(s, 8, 1, "flat") for s in STRATEGIES]
        + [("pair_range", 8, 1, "ring"), ("pair_range", 8, 1, "hierarchical"),
           ("sorted_neighborhood", 8, 1, "ring"), ("pair_range", 4, 2, "flat")])

REFERENCE = f"""
import sys
import numpy as np
import jax.numpy as jnp
from repro.core import (blocked_layout, compute_bdm, entity_indices,
                        plan_basic, plan_block_split, plan_pair_range)
from repro.er import ERConfig, make_products, run_er, sn_sort_order
from repro.er.blocking import prefix_block_ids
from repro.er.compiler import schedule_tiles
from repro.er.distributed import (compute_bdm_sharded, match_catalog_2src_dist,
                                  match_catalog_dist, match_sn_dist)
from repro.er.encode import encode_titles, ngram_features
from repro.er.executor import build_catalog, catalog_for_cross
from repro.er.pipeline import featurize
from repro.er.service import ServiceConfig
from repro.sharding import make_er_mesh
from sn_oracle import sn_oracle_matches

N_DEV, DIM, MAXLEN = {N_DEV}, {DIM}, {MAXLEN}
out = {{}}
mesh = make_er_mesh(N_DEV)
ds = make_products(1024, seed=5)
bid, _ = prefix_block_ids(ds.titles, ds.prefix_len)
n = ds.n - ds.n % N_DEV
titles, bid = ds.titles[:n], bid[:n]
num_blocks = int(bid.max()) + 1
part = np.repeat(np.arange(N_DEV), n // N_DEV)
bdm = compute_bdm(bid, part, num_blocks, N_DEV)
out["bdm"] = np.asarray(compute_bdm_sharded(jnp.asarray(bid, jnp.int32),
                                            num_blocks, mesh))

codes, lens = encode_titles(titles, MAXLEN)
feats = ngram_features(codes, dim=DIM, lengths=lens)
eidx = entity_indices(bid, part, bdm)
plan = plan_pair_range(bdm, N_DEV)
perm, estart = blocked_layout(bid, eidx, plan.block_sizes)
fb = jnp.asarray(feats[perm])
for name, p in (("basic", plan_basic(bdm, N_DEV)), ("block_split",
                                   plan_block_split(bdm, N_DEV)),
                ("pair_range", plan)):
    cat = build_catalog(p, block_m=128, block_n=128)
    out["cat_" + name] = np.stack(match_catalog_dist(fb, cat, mesh,
                                                     threshold=0.55))
    sched = schedule_tiles(cat, n_dev=N_DEV)
    out["catsched_" + name] = np.stack(match_catalog_dist(
        fb, cat, mesh, threshold=0.55, schedule=sched))

cfg = ServiceConfig(feature_dim=128, max_len=48)
corpus = ds.titles[:500]
_, _, cf = featurize(corpus[:64], cfg)
_, _, qf = featurize(ds.titles[500:516], cfg)
cross = catalog_for_cross(64, 16, r=16, block_m=16, block_n=16)
out["x2src"] = np.stack(match_catalog_2src_dist(cf, qf, cross, mesh,
                                                threshold=0.55,
                                                chunk_tiles=32))

order = sn_sort_order(titles)
fs = jnp.asarray(feats[order])
for w in (64, n // N_DEV + 37):
    out[f"sn_{{w}}"] = np.stack(match_sn_dist(fs, w, mesh, threshold=0.55))
    oracle = sn_oracle_matches(titles, w, feature_dim=DIM, max_len=MAXLEN)
    out[f"oracle_{{w}}"] = np.asarray(sorted(oracle), np.int64).reshape(-1, 2)

for strategy, n_data, n_model, comms in {RUNS!r}:
    res = run_er(titles, ERConfig(strategy=strategy, r=N_DEV, m=N_DEV,
                                  feature_dim=DIM, max_len=MAXLEN,
                                  block_m=64, block_n=64, comms=comms),
                 mesh=make_er_mesh(n_data, n_model))
    key = f"{{strategy}}_{{n_data}}_{{n_model}}_{{comms}}"
    out["run_" + key] = np.asarray(sorted(res.matches),
                                   np.int64).reshape(-1, 2)
    out["fallback_" + key] = np.asarray(res.extra.get("comms_fallback", ""))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tp.jax_mesh_reference(
        REFERENCE, tmp_path_factory.mktemp("jax_dist") / "ref.npz")


@pytest.fixture(scope="module")
def inputs():
    """tests/test_distributed_er.py's inputs, built by the port."""
    ds = make_products(1024, seed=5)
    bid, _ = prefix_block_ids(ds.titles, ds.prefix_len)
    n = ds.n - ds.n % N_DEV
    titles, bid = list(ds.titles[:n]), bid[:n]
    num_blocks = int(bid.max()) + 1
    part = np.repeat(np.arange(N_DEV), n // N_DEV)
    bdm = compute_bdm(bid, part, num_blocks, N_DEV)
    codes, lens = encode_titles(titles, MAXLEN)
    feats = ngram_features(codes, dim=DIM, lengths=lens)
    plan = plan_pair_range(bdm, N_DEV)
    perm, estart = blocked_layout(bid, entity_indices(bid, part, bdm),
                                  plan.block_sizes)
    return dict(ds=ds, titles=titles, bid=bid, num_blocks=num_blocks,
                bdm=bdm, codes=codes, lens=lens, feats=feats, plan=plan,
                perm=perm, estart=estart, mesh=tp.cpu_mesh(N_DEV))


def test_compute_bdm_sharded(ref, inputs):
    got = dist.compute_bdm_sharded(inputs["bid"], inputs["num_blocks"],
                                   inputs["mesh"])
    np.testing.assert_array_equal(got.numpy(), inputs["bdm"])
    np.testing.assert_array_equal(got.numpy(), ref["bdm"])


@pytest.mark.parametrize("scheduled", [False, True])
@pytest.mark.parametrize("strategy", ["basic", "block_split", "pair_range"])
def test_match_catalog_dist(ref, inputs, strategy, scheduled):
    bdm = inputs["bdm"]
    p = {"basic": plan_basic, "block_split": plan_block_split,
         "pair_range": plan_pair_range}[strategy](bdm, N_DEV)
    cat = lower(plan_to_job(p), 128, 128)
    sched = schedule_tiles(cat, n_dev=N_DEV) if scheduled else None
    got = dist.match_catalog_dist(inputs["feats"][inputs["perm"]], cat,
                                  inputs["mesh"], threshold=0.55,
                                  schedule=sched)
    key = ("catsched_" if scheduled else "cat_") + strategy
    assert tp.pair_set(*got) == tp.pair_set(*ref[key])


def test_match_catalog_2src_dist_and_scorer(ref, inputs):
    """The one-shot cross matcher and a held scorer driven over padded
    device shards: both equal the reference's survivors and the host
    cosine oracle."""
    cfg = ERConfig(feature_dim=128, max_len=48)
    corpus = list(inputs["ds"].titles[:500])
    _, _, cf = featurize(corpus[:64], cfg)
    _, _, qf = featurize(list(inputs["ds"].titles[500:516]), cfg)
    cross = catalog_for_cross(64, 16, r=16, block_m=16, block_n=16)
    got = dist.match_catalog_2src_dist(cf, qf, cross, inputs["mesh"],
                                       threshold=0.55, chunk_tiles=32)
    want = tp.pair_set(*ref["x2src"])
    assert tp.pair_set(*got) == want
    wa, wb = np.nonzero(cf @ qf.T >= np.float32(0.55))
    assert want == tp.pair_set(wa, wb)
    scorer = dist.make_catalog_2src_scorer(inputs["mesh"], threshold=0.55,
                                           block_m=16, block_n=16)
    tiles = dist.pad_device_tiles(
        dist.plan_tiles_for_devices(cross, N_DEV), 32)
    assert tp.pair_set(*dist.score_tiles_2src(
        scorer, cf, qf, tiles, 32, 16, 16)) == want


@pytest.mark.parametrize("w_key", ["one_hop", "multi_hop"])
def test_match_sn_dist(ref, inputs, w_key):
    n = len(inputs["titles"])
    w = 64 if w_key == "one_hop" else n // N_DEV + 37
    order = sn_sort_order(inputs["titles"])
    codes, lens = inputs["codes"][order], inputs["lens"][order]
    ca, cb = dist.match_sn_dist(inputs["feats"][order], w, inputs["mesh"],
                                threshold=0.55)
    assert tp.pair_set(ca, cb) == tp.pair_set(*ref[f"sn_{w}"])
    ha, hb = verify_pairs(codes, lens, codes, lens, ca, cb, 0.8,
                          device="cpu")
    got = {(min(int(order[a]), int(order[b])),
            max(int(order[a]), int(order[b]))) for a, b in zip(ha, hb)}
    assert got == set(map(tuple, ref[f"oracle_{w}"].tolist()))
    hops = -(-(w - 1) // (n // N_DEV))
    assert (hops >= 2) == (w_key == "multi_hop")
    per_hop = dist.sn_replication_volume(n, w, N_DEV, DIM, per_hop=True)
    assert len(per_hop) == hops and sum(per_hop) == (w - 1) * DIM * 4


@pytest.mark.parametrize("args", [(1016, 64, 8, 128), (1016, 164, 8, 128),
                                  (1016, 10, 1, 128), (100, 500, 4, 64),
                                  (4096, 9, 16, 256)])
@pytest.mark.parametrize("per_hop", [False, True])
def test_sn_replication_volume(args, per_hop):
    assert (dist.sn_replication_volume(*args, per_hop=per_hop)
            == j_sn_replication_volume(*args, per_hop=per_hop))


@pytest.mark.parametrize("case", RUNS,
                         ids=["-".join(map(str, c)) for c in RUNS])
def test_run_er_mesh(ref, inputs, case):
    strategy, n_data, n_model, comms = case
    cfg = ERConfig(strategy=strategy, r=N_DEV, m=N_DEV, feature_dim=DIM,
                   max_len=MAXLEN, block_m=64, block_n=64, comms=comms)
    plain = run_er(inputs["titles"], cfg, device="cpu")
    res = run_er(inputs["titles"], cfg, mesh=tp.cpu_mesh(n_data, n_model),
                 device="cpu")
    key = f"{strategy}_{n_data}_{n_model}_{comms}"
    want = set(map(tuple, ref["run_" + key].tolist()))
    assert want and res.matches == plain.matches == want
    assert res.extra.get("comms_fallback", "") == str(ref["fallback_" + key])


def test_run_er_mesh_checks():
    titles = list(make_products(300, seed=1).titles)
    mesh = tp.cpu_mesh(2)
    card_mesh = sharding.make_er_mesh(2, devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="device type"):
        run_er(titles, ERConfig(), mesh=card_mesh, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        run_er(titles, ERConfig(supervised_devices=2), mesh=mesh,
               device="cpu")
    with pytest.raises(ValueError, match="catalog"):
        run_er(titles, ERConfig(executor="reference"), mesh=mesh,
               device="cpu")
    with pytest.raises(ValueError, match="comms"):
        run_er(titles, ERConfig(comms="mesh2d"), device="cpu")

"""The port's mesh (``repro_torch.sharding`` and ``execute(mesh=...)``) on
logical CPU shards, against the JAX package on simulated host devices.

One subprocess per module runs the reference (``make_er_mesh`` over 16
simulated devices) on the inputs of tests/test_mesh_comms.py's parity
script and of tests/test_empty_shard.py, and saves its inputs, its
single-host and mesh survivors and its per-run interconnect counters.
The port then runs ``execute`` on the same inputs at (n_data, n_model) ∈
{(2, 1), (4, 1), (8, 1), (8, 2)} × {flat, ring, hierarchical} × compact
{True, False}: survivors equal the port's single-host set and the JAX
package's (on the model axis only pairs within float ulps of the
threshold may differ), and ``stage1_stats["interconnect"]`` moves
exactly as the reference's did. The collectives are checked on their
own, and the bytes the scorer's collectives move between distinct
shards are held to the comms formulas.
"""
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
import torch_parity as tp  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.er.compiler import execute as j_execute  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.core import (compute_bdm, plan_block_split,  # noqa: E402
                              plan_pair_range)
from repro_torch.er.compiler import (execute, lower, plan_comms,  # noqa: E402
                                     plan_to_job, schedule_tiles,
                                     stage1_stats, tiles_for_devices)

# the module (the package re-exports its ``execute`` function by that name)
execute_mod = sys.modules["repro_torch.er.compiler.execute"]

MESHES = [(2, 1), (4, 1), (8, 1), (8, 2)]
POLICIES = ["flat", "ring", "hierarchical"]
FLOWS = ["flat_bytes", "ring_bytes", "hier_intra_bytes", "hier_inter_bytes",
         "halo_bytes", "psum_bytes"]
THR = 0.1
ES_THR = 0.4

REFERENCE = f"""
import sys
import numpy as np
import jax.numpy as jnp
from repro.sharding import make_er_mesh
from repro.core import compute_bdm, plan_block_split, plan_pair_range
from repro.er.compiler import execute, lower, plan_to_job, schedule_tiles
from repro.er.compiler.execute import stage1_stats

FLOWS = {FLOWS!r}
out = {{}}

def parity_inputs(n_data):
    # tests/test_mesh_comms.py's PARITY inputs
    n, d = n_data * 128, 64
    rng = np.random.default_rng(7)
    cuts = np.sort(rng.choice(np.arange(1, n), 15, replace=False))
    bids = np.repeat(np.arange(16), np.diff(np.r_[0, cuts, n]))
    feats = rng.standard_normal((n, d)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    return bids, feats

for n_data, n_model in {MESHES!r}:
    bids, feats = parity_inputs(n_data)
    n = bids.size
    bdm = compute_bdm(bids, np.zeros(n, np.int64), 16, 1)
    cat = lower(plan_to_job(plan_pair_range(bdm, 8)), 64, 64)
    out[f"bids_{{n_data}}"], out[f"feats_{{n_data}}"] = bids, feats
    out[f"tiles_{{n_data}}"] = cat.tiles
    out[f"single_{{n_data}}"] = np.stack(execute(
        cat, jnp.asarray(feats), threshold={THR}, impl="xla"))
    mesh = make_er_mesh(n_data, n_model)
    for comms in {POLICIES!r}:
        key = f"{{n_data}}_{{n_model}}_{{comms}}"
        before = dict(stage1_stats["interconnect"])
        ra, rb = execute(cat, jnp.asarray(feats), threshold={THR},
                         impl="xla", mesh=mesh, comms=comms, compact=True,
                         model_axis="model" if n_model > 1 else None)
        after = stage1_stats["interconnect"]
        out["mesh_" + key] = np.stack([ra, rb])
        out["flows_" + key] = np.array([after[k] - before[k] for k in FLOWS])

# tests/test_empty_shard.py: one dominant block, 8 devices, shrunken chunks
sizes = np.array([120, 5, 3], np.int64)
n = int(sizes.sum())
bdm = compute_bdm(np.repeat(np.arange(3), sizes), np.zeros(n, np.int64), 3, 1)
cat = lower(plan_to_job(plan_block_split(bdm, 4)), 64, 64)
sched = schedule_tiles(cat, n_dev=8, policy="cost_lpt")
rng = np.random.default_rng(0)
feats = rng.normal(size=(n, 64)).astype(np.float32)
feats /= np.linalg.norm(feats, axis=1, keepdims=True)
mesh = make_er_mesh(8)
out["es_feats"] = feats
out["es_single"] = np.stack(execute(cat, feats, threshold={ES_THR}))
out["es_mesh"] = np.stack(execute(cat, feats, threshold={ES_THR}, mesh=mesh,
                                  schedule=sched, chunk_tiles=1024,
                                  fixed_chunks=False))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tp.jax_mesh_reference(
        REFERENCE, tmp_path_factory.mktemp("jax_mesh") / "ref.npz")


def _catalog(ref, n_data):
    bids = ref[f"bids_{n_data}"]
    n = bids.size
    bdm = compute_bdm(bids, np.zeros(n, np.int64), 16, 1)
    cat = lower(plan_to_job(plan_pair_range(bdm, 8)), 64, 64)
    np.testing.assert_array_equal(cat.tiles, ref[f"tiles_{n_data}"])
    return cat


def _flows(before):
    return np.array([stage1_stats["interconnect"][k] - before[k]
                     for k in FLOWS])


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------

def test_make_er_mesh_shape_and_order():
    devs = [f"cpu:{i}" for i in range(8)]
    mesh = sharding.make_er_mesh(4, 2, devices=devs)
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.devices.shape == (4, 2)
    # row-major, model fastest
    assert [str(d) for d in mesh.devices.flat] == devs
    assert mesh.grid("data", "model").shape == (4, 2)
    assert mesh.grid("data").shape == (4, 1)
    assert mesh.grid("model", "data").shape == (2, 4)
    assert mesh.first_device == torch.device("cpu", 0)
    one = sharding.make_er_mesh(8, devices=["cpu"] * 9)
    assert one.shape == {"data": 8, "model": 1}
    assert {str(d) for d in one.devices.flat} == {"cpu"}


@pytest.mark.parametrize("bad", [
    dict(n_data=4, n_model=2, devices=["cpu"] * 7),
    dict(n_data=0, devices=["cpu"]),
    dict(n_data=2, devices=["cpu", "meta"]),
])
def test_make_er_mesh_raises(bad):
    with pytest.raises(ValueError):
        sharding.make_er_mesh(**bad)


def test_make_er_mesh_takes_no_cpu_by_itself():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(ValueError, match="have 0"):
        sharding.make_er_mesh(1)


def test_axis_index():
    mesh = tp.cpu_mesh(4, 2)
    np.testing.assert_array_equal(sharding.axis_index(mesh, "data"),
                                  np.repeat(np.arange(4), 2).reshape(4, 2))
    np.testing.assert_array_equal(sharding.axis_index(mesh, "model"),
                                  np.tile(np.arange(2), 4).reshape(4, 2))


def test_collectives():
    devs = ["cpu"] * 4
    shards = [torch.full((2, 3), float(i)) for i in range(4)]
    traffic = [0] * 4
    got = sharding.all_gather(shards, devs, traffic)
    for g in got:
        assert torch.equal(g, torch.cat(shards))
    assert traffic == [3 * 2 * 3 * 4] * 4
    traffic = [0] * 4
    out = sharding.ppermute(shards, [(0, 1), (1, 2), (3, 3)], devs, traffic)
    assert torch.equal(out[1], shards[0]) and torch.equal(out[2], shards[1])
    assert torch.equal(out[3], shards[3]) and not out[0].any()
    assert traffic == [0, 24, 24, 0]          # 3 → 3 crosses nothing
    summed = sharding.psum(shards, devs)
    for s in summed:
        assert torch.equal(s, torch.full((2, 3), 6.0))
    x = np.arange(48, dtype=np.float32).reshape(8, 6)
    grid = tp.cpu_mesh(4, 2).grid("data", "model")
    sh = sharding.shard_rows(x, grid)
    assert sh.shape == (8, 6) and sh.row_split
    np.testing.assert_array_equal(sh.blocks[3][1].numpy(), x[6:8, 3:6])
    rep = sharding.replicate(x, grid)
    np.testing.assert_array_equal(rep.blocks[2][0].numpy(), x[:, :3])
    with pytest.raises(ValueError):
        sharding.shard_rows(x[:7], grid)


@pytest.mark.parametrize("flow", ["flat", "ring", "hierarchical", "halo"])
def test_scorer_traffic_equals_the_formulas(monkeypatch, flow):
    """The bytes the scorer's collectives move between distinct shards,
    per shard and launch, equal what ``stage1_stats`` records from the
    comms formulas (8 data shards; the halo crosses two shards)."""
    traffic = [0] * 8
    for name in ("all_gather", "ppermute"):
        real = getattr(sharding, name)
        monkeypatch.setattr(
            execute_mod, name,
            lambda *a, _real=real, **k: _real(*a, traffic=traffic, **k))
    rng = np.random.default_rng(3)
    n = 8 * 128
    feats = tp.unit(rng, n, 64)
    before = dict(stage1_stats["interconnect"])
    if flow == "halo":
        from repro_torch.er.distributed import match_sn_dist
        match_sn_dist(feats, 128 + 37 + 1, tp.cpu_mesh(8), threshold=0.5,
                      block_m=64, block_n=64)
    else:
        cuts = np.sort(rng.choice(np.arange(1, n), 15, replace=False))
        bids = np.repeat(np.arange(16), np.diff(np.r_[0, cuts, n]))
        cat = lower(plan_to_job(plan_pair_range(
            compute_bdm(bids, np.zeros(n, np.int64), 16, 1), 8)), 64, 64)
        plan = plan_comms(cat, n, 8, policy=flow, feature_dim=64)
        assert plan.fallback is None and plan.hops + plan.inter_hops > 0 \
            or flow == "flat"
        execute(cat, feats, threshold=0.5, mesh=tp.cpu_mesh(8), comms=flow,
                chunk_tiles=8)          # several launches
    recorded = sum(stage1_stats["interconnect"][k] - before[k]
                   for k in FLOWS)
    assert recorded > 0
    assert traffic == [recorded] * 8, (traffic, recorded)


# ---------------------------------------------------------------------------
# execute on the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("comms", POLICIES)
@pytest.mark.parametrize("n_data,n_model", MESHES)
def test_execute_mesh_parity(ref, record_property, n_data, n_model, comms,
                             compact):
    cat = _catalog(ref, n_data)
    feats = ref[f"feats_{n_data}"]
    single = execute(cat, feats, threshold=THR, device="cpu")
    want = tp.pair_set(*ref[f"single_{n_data}"])
    assert tp.pair_set(*single) == want
    key = f"{n_data}_{n_model}_{comms}"
    before = dict(stage1_stats["interconnect"])
    got = tp.pair_set(*execute(
        cat, feats, threshold=THR, mesh=tp.cpu_mesh(n_data, n_model),
        comms=comms, compact=compact,
        model_axis="model" if n_model > 1 else None))
    np.testing.assert_array_equal(_flows(before), ref["flows_" + key])
    jax_mesh = tp.pair_set(*ref["mesh_" + key])
    if n_model == 1:
        assert got == want == jax_mesh
        return
    # The psum reassociates the d-dot: only threshold-ulp scores may flip.
    flips = tp.near_threshold_flips(got, want, feats, feats, THR)
    flips += tp.near_threshold_flips(got, jax_mesh, feats, feats, THR)
    record_property("near_threshold_flips", len(flips))


def test_empty_shard_fixed_chunks_false(ref):
    """tests/test_empty_shard.py: 8-way LPT leaves shards empty, the
    shrunken chunk still pads to one all-zero tile, and the mesh scores
    the single-host survivor set (the reference's, too)."""
    sizes = np.array([120, 5, 3], np.int64)
    n = int(sizes.sum())
    bdm = compute_bdm(np.repeat(np.arange(3), sizes), np.zeros(n, np.int64),
                      3, 1)
    cat = lower(plan_to_job(plan_block_split(bdm, 4)), 64, 64)
    sched = schedule_tiles(cat, n_dev=8, policy="cost_lpt")
    per_dev = np.bincount(sched.reducer_device[sched.tile_reducer],
                          minlength=8)
    assert (per_dev == 0).any()
    assert tiles_for_devices(cat, 8, schedule=sched).shape[1] >= 1
    feats = ref["es_feats"]
    want = tp.pair_set(*ref["es_single"])
    assert want and tp.pair_set(*ref["es_mesh"]) == want
    assert tp.pair_set(*execute(cat, feats, threshold=ES_THR,
                                device="cpu")) == want
    got = execute(cat, feats, threshold=ES_THR, mesh=tp.cpu_mesh(8),
                  schedule=sched, chunk_tiles=1024, fixed_chunks=False)
    assert tp.pair_set(*got) == want
    # one tile: the chunk shrinks all the way to 1
    one = lower(plan_to_job(plan_block_split(
        compute_bdm(np.zeros(40, np.int64), np.zeros(40, np.int64), 1, 1),
        1)), 64, 64)
    sched1 = schedule_tiles(one, n_dev=8, policy="cost_lpt")
    want1 = tp.pair_set(*j_execute(one, jnp.asarray(feats[:40]),
                                   threshold=ES_THR))
    got1 = execute(one, feats[:40], threshold=ES_THR, mesh=tp.cpu_mesh(8),
                   schedule=sched1, fixed_chunks=False)
    assert tp.pair_set(*got1) == want1


def test_mesh_raises_like_the_reference():
    cat = lower(plan_to_job(plan_pair_range(compute_bdm(
        np.zeros(256, np.int64), np.zeros(256, np.int64), 1, 1), 2)), 64, 64)
    feats = tp.unit(np.random.default_rng(0), 256, 16)
    mesh = tp.cpu_mesh(4)
    with pytest.raises(ValueError, match="halo"):
        execute(cat, feats, threshold=0.5, mesh=mesh, comms="ring", halo=3)
    with pytest.raises(ValueError, match="healthy"):
        execute(cat, feats, threshold=0.5, mesh=mesh, comms="ring",
                healthy=np.array([True, False, True, True]))
    with pytest.raises(ValueError, match="comms"):
        execute(cat, feats, threshold=0.5, mesh=mesh, comms="mesh2d")

"""The port's two legacy mesh executors of ``er/distributed.py`` —
``match_pair_range_dist`` (every shard derives its pairs by the
closed-form inverse) and ``match_shards_hostplan`` (per-device padded
row pairs) — and the torch twin of ``pairs_of_range_jnp`` they rest on,
against the JAX package.

One subprocess per module runs the reference executors on 8 simulated
host devices (their in-shard_map edit distance takes most of its time)
on tests/test_distributed_er.py's inputs and saves their arrays; the
port runs on logical CPU shards."""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
import torch_parity as tp  # noqa: E402
from repro.core import enumeration as j_en  # noqa: E402
from repro.core.pair_range import pairs_of_range_jnp  # noqa: E402
from repro.core.pair_range import (  # noqa: E402
    plan_pair_range as j_plan_pair_range)
from repro_torch.core import enumeration as en  # noqa: E402
from repro_torch.core import plan_pair_range  # noqa: E402
from repro_torch.core.pair_range import pairs_of_range_torch  # noqa: E402
from repro_torch.er import distributed as dist  # noqa: E402

N_DEV = tp.LEGACY_N_DEV


REFERENCE = f"""
import sys
import numpy as np
import jax.numpy as jnp
import repro.core as core
import repro.er as er
from repro.er.distributed import (match_pair_range_dist,
                                  match_shards_hostplan,
                                  plan_rows_for_devices)
from repro.sharding import make_er_mesh
from torch_parity import legacy_mesh_inputs

feats, codes, lens, plan, rows = legacy_mesh_inputs(core, er)
mesh = make_er_mesh({tp.LEGACY_N_DEV})
fb, cb, lb = (jnp.asarray(x) for x in (feats, codes, lens))
out = {{}}
for k, v in zip("ra rb mask score".split(),
                match_pair_range_dist(fb, cb, lb, plan, mesh)):
    out["prd_" + k] = np.asarray(v)
ra, rb, valid = plan_rows_for_devices(rows, {tp.LEGACY_N_DEV},
                                      {tp.LEGACY_N_DEV})
mask, score = match_shards_hostplan(fb, cb, lb, jnp.asarray(ra),
                                    jnp.asarray(rb), jnp.asarray(valid), mesh)
out["hp_mask"], out["hp_score"] = np.asarray(mask), np.asarray(score)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tp.jax_mesh_reference(
        REFERENCE, tmp_path_factory.mktemp("jax_legacy") / "ref.npz")


@pytest.fixture(scope="module")
def inputs():
    import repro_torch.core as core
    import repro_torch.er as er
    return tp.legacy_mesh_inputs(core, er)


def test_match_pair_range_dist(ref, inputs):
    feats, codes, lens, plan, _ = inputs
    got = dist.match_pair_range_dist(feats, codes, lens, plan,
                                     tp.cpu_mesh(N_DEV))
    for name, g in zip(("ra", "rb", "mask"), got[:3]):
        np.testing.assert_array_equal(g.numpy(), ref["prd_" + name],
                                      err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), ref["prd_score"], atol=1e-6)
    assert got[2].any()


def test_match_shards_hostplan(ref, inputs):
    feats, codes, lens, _, rows = inputs
    ra, rb, valid = dist.plan_rows_for_devices(rows, N_DEV, N_DEV)
    mask, score = dist.match_shards_hostplan(feats, codes, lens, ra, rb,
                                             valid, tp.cpu_mesh(N_DEV))
    np.testing.assert_array_equal(mask.numpy(), ref["hp_mask"])
    np.testing.assert_allclose(score.numpy(), ref["hp_score"], atol=1e-6)
    assert mask.any()


@pytest.mark.parametrize("sizes,lo,count", [
    ([5, 1, 9, 2, 40], 0, 50), ([5, 1, 9, 2, 40], 13, 900),
    ([3000], 0, 4096), ([3000], 4_000_000, 600_000),
    ([46_000, 7], 1_057_000_000, 4096),
])
def test_pairs_of_range_twin(sizes, lo, count):
    """The torch twin against the exact numpy inverse of both packages,
    and against the reference's ``pairs_of_range_jnp`` (int32) where its
    product x·(2n−x−1) stays inside int32 (blocks below ~46k rows)."""
    bdm = np.asarray(sizes, np.int64)[:, None]
    plan = plan_pair_range(bdm, 1)
    total = int(plan.total_pairs)
    ra, rb, valid = (x.numpy() for x in pairs_of_range_torch(
        torch.as_tensor(plan.block_sizes), torch.as_tensor(plan.offsets),
        torch.as_tensor(plan.estart), lo, count, total))
    p = np.arange(lo, lo + count)
    np.testing.assert_array_equal(valid, p < total)
    inside = p[p < total]
    block, x, y = en.invert_pair_index(inside, plan.block_sizes, plan.offsets)
    np.testing.assert_array_equal(ra[valid], plan.estart[block] + x)
    np.testing.assert_array_equal(rb[valid], plan.estart[block] + y)
    jplan = j_plan_pair_range(bdm, 1)
    jblock, jx, _ = j_en.invert_pair_index(inside, jplan.block_sizes,
                                           jplan.offsets)
    np.testing.assert_array_equal(ra[valid], jplan.estart[jblock] + jx)
    if max(sizes) ** 2 < 2 ** 31:
        ja, jb, jv = (np.asarray(v) for v in pairs_of_range_jnp(
            np.asarray(jplan.block_sizes, np.int32),
            np.asarray(jplan.offsets, np.int32),
            np.asarray(jplan.estart, np.int32), lo, count, total))
        np.testing.assert_array_equal(valid, jv)
        np.testing.assert_array_equal(ra[valid], ja[jv])
        np.testing.assert_array_equal(rb[valid], jb[jv])

"""The port's catalog kernels on the CPU, beyond the dyadic sweep: the
plain versions on random-normal inputs (a cell may differ only when its
f64 score lies within 1e-6 of the threshold), against the Pallas kernels
in interpret mode, predicate by predicate, and on the compaction contract
of tests/test_batcher.py; plus the dispatcher and the shared-memory
model."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import compute_bdm as j_compute_bdm  # noqa: E402
from repro.core import plan_pair_range as j_plan_pair_range  # noqa: E402
from repro.er.compiler import lower as j_lower, plan_to_job as j_plan_to_job  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops, pair_sim, ref  # noqa: E402
from torch_parity import (DTYPES, SHAPES, assert_near_threshold_only,  # noqa: E402
                          catalog, dyadic, unit)


def _port(x, dtype="float32"):
    return convert.to_device(x, "cpu", getattr(torch, dtype))


def _jax(x, dtype="float32"):
    return jnp.asarray(x, getattr(jnp, dtype))



@pytest.mark.parametrize("m,n,d", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_on_random_inputs_differs_only_at_threshold(m, n, d, dtype):
    rng = np.random.default_rng(d + n)
    a, b = unit(rng, m, d), unit(rng, n, d)
    if dtype == "bfloat16":           # the values both sides actually see
        a = _port(a, dtype).float().numpy()
        b = _port(b, dtype).float().numpy()
    cat = catalog(rng, m, n, 32, 32, t=40)
    thr = round(2.0 / np.sqrt(d), 3)              # ~2σ of a random cosine
    kw = dict(threshold=thr, block_m=32, block_n=32)
    got = ops.pair_scores_catalog(_port(a, dtype), _port(b, dtype),
                                  _port(cat), impl="torch", **kw).numpy()
    want = np.asarray(jops.pair_scores_catalog(
        _jax(a, dtype), _jax(b, dtype), jnp.asarray(cat), impl="xla", **kw))
    assert got.sum() > 0
    assert_near_threshold_only(got, want, a, b, cat, 32, 32, thr)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_equals_pallas_interpret(dtype):
    rng = np.random.default_rng(5)
    a, b = dyadic(rng, 100, 64), dyadic(rng, 70, 64)
    cat = catalog(rng, 100, 70, 32, 32, t=6, pad=2)
    kw = dict(threshold=0.25, block_m=32, block_n=32)
    want = jops.pair_scores_catalog(_jax(a, dtype), _jax(b, dtype),
                                    jnp.asarray(cat), impl="interpret", **kw)
    got = ops.pair_scores_catalog(_port(a, dtype), _port(b, dtype),
                                  _port(cat), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    wp, wc = jops.pair_scores_catalog_compact(
        _jax(a, dtype), _jax(b, dtype), jnp.asarray(cat), capacity=16,
        impl="interpret", **kw)
    gp, gc = ops.pair_scores_catalog_compact(
        _port(a, dtype), _port(b, dtype), _port(cat), capacity=16, **kw)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


@pytest.mark.parametrize("only", ["window", "tri", "lb", "ub", "band"])
def test_each_predicate_alone(only):
    rng = np.random.default_rng(11)
    a = dyadic(rng, 96, 32)
    cat = catalog(rng, 96, 96, 32, 32, t=30, only=only)
    kw = dict(threshold=-1.0, block_m=32, block_n=32)   # predicate only
    got = ops.pair_scores_catalog(_port(a), _port(a), _port(cat), **kw)
    want = jref.pair_scores_catalog_ref(_jax(a), _jax(a), jnp.asarray(cat),
                                        **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # every predicate removes something somewhere, except the full window
    assert got.sum() < 30 * 32 * 32


BM = BN = 16


@pytest.mark.parametrize("capacity", (4, 32, BM * BN))
def test_compact_contract_matches_interpret_and_xla(capacity):
    """The compaction cases of tests/test_batcher.py: counts exact past
    capacity, survivors in row-major order, dead slots zero."""
    sizes = np.array([40, 21, 9], np.int64)
    n = int(sizes.sum())
    bdm = j_compute_bdm(np.repeat(np.arange(3), sizes), np.zeros(n, np.int64),
                        3, 1)
    jcat = j_lower(j_plan_to_job(j_plan_pair_range(bdm, 4)), BM, BN)
    cat = convert.catalog_from(jcat)
    f = dyadic(np.random.default_rng(0), n, 32)
    kw = dict(threshold=0.0, block_m=BM, block_n=BN, capacity=capacity)
    gp, gc = ops.pair_scores_catalog_compact(_port(f), _port(f),
                                             _port(cat.tiles), **kw)
    flat = ops.pair_scores_catalog(
        _port(f), _port(f), _port(cat.tiles), threshold=0.0, block_m=BM,
        block_n=BN).numpy().reshape(cat.num_tiles, -1).astype(bool)
    counts = gc.numpy().reshape(-1)
    assert flat.sum(axis=1).max() > 4
    np.testing.assert_array_equal(counts, flat.sum(axis=1))
    for t in range(flat.shape[0]):
        pos = np.flatnonzero(flat[t])
        k = min(pos.size, capacity)
        np.testing.assert_array_equal(gp.numpy()[t, :k], pos[:k])
        assert (gp.numpy()[t, k:] == 0).all()
    for impl in ("interpret", "xla"):
        wp, wc = jops.pair_scores_catalog_compact(
            _jax(f), _jax(f), jnp.asarray(jcat.tiles), impl=impl, **kw)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


def test_dispatcher_resolution():
    assert ops.resolve_impl("auto", "cpu") == "torch"
    assert ops.resolve_impl("torch", "cpu") == "torch"
    assert ops.resolve_impl("auto", "cuda") == "cuda"
    assert ops.resolve_impl("torch", "cuda") == "torch"
    with pytest.raises(ValueError):
        ops.resolve_impl("cuda", "cpu")
    with pytest.raises(ValueError):
        ops.resolve_impl("xla", "cpu")


def test_cpu_tensors_run_the_plain_version_without_launching():
    rng = np.random.default_rng(2)
    a = _port(dyadic(rng, 64, 16))
    cat = _port(catalog(rng, 64, 64, 32, 32, t=4))
    kw = dict(threshold=0.25, block_m=32, block_n=32)
    ops.reset_launch_counts()
    got = ops.pair_scores_catalog(a, a, cat, impl="auto", **kw)
    assert torch.equal(got, ref.pair_scores_catalog_ref(a, a, cat, **kw))
    gp, gc = ops.pair_scores_catalog_compact(a, a, cat, capacity=8,
                                             impl="auto", **kw)
    wp, wc = ref.pair_scores_catalog_compact_ref(a, a, cat, capacity=8, **kw)
    assert torch.equal(gp, wp) and torch.equal(gc, wc)
    counts = ops.launch_counts()
    assert {"pair_scores_catalog", "pair_scores_catalog_compact"} <= set(
        counts)
    assert not any(counts.values()), counts
    with pytest.raises(ValueError):
        ops.pair_scores_catalog(a, a, cat, impl="cuda")
    # the CUDA wrappers themselves take CUDA tensors only
    with pytest.raises(ValueError):
        pair_sim.pair_scores_catalog(a, a, cat, **kw)
    with pytest.raises(ValueError):
        pair_sim.pair_scores_catalog_compact(a, a, cat, capacity=8, **kw)


def test_shared_memory_model():
    for bm, bn in pair_sim.GEOMETRY_LATTICE:
        need = pair_sim.catalog_smem_bytes(bm, bn)
        assert 0 < need <= pair_sim.SMEM_BUDGET_BYTES
        pair_sim.check_smem(bm, bn)
    # 128x128: two 32 x 129 f32 chunks + 512 words of keep bits
    assert pair_sim.catalog_smem_bytes(128, 128) == 4 * (32 * 258 + 512)
    for bad in ((16, 16), (512, 32), (96, 128)):
        with pytest.raises(ValueError):
            pair_sim.check_smem(*bad)

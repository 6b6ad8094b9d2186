"""The port's model-side partition specs against the JAX package's
(``repro.sharding``), at full size: for every param of every arch the
port's spec (a model built on the meta device) equals the reference's
``PartitionSpec`` of ``jax.eval_shape(mod.init)`` with its leading layer
stack dims dropped; ``cache_shardings`` for every arch × the serve
shapes; ``batch_spec`` / ``cache_spec`` over a grid of kv-head counts
and batch sizes; all over abstract meshes (16, 16), (2, 16, 16) and
(2, 2), so no devices are needed. ``constrain`` and its wrappers are the
identity and check the spec's rank."""
import functools

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
import torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro import configs as jconfigs  # noqa: E402
from repro import sharding as jshd  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
ARCHS = sorted(jconfigs.ARCHS)
SERVE = [s for s, v in jconfigs.SHAPES.items() if v.kind != "train"]


def _norm(spec, ndim=None, drop=0):
    """Entries of a spec padded to ``ndim``, the first ``drop`` dropped,
    trailing Nones trimmed, one-name tuples as the name."""
    entries = list(spec) + [None] * max((ndim or 0) - len(spec), 0)
    entries = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
               for e in entries[drop:]]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _meshes(name):
    sizes, axes = MESHES[name]
    return JAbstractMesh(sizes, axes), shd.AbstractMesh(sizes, axes)


def _ref_leaves(tree):
    return {tuple(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: hasattr(x, "spec"))[0]}


@pytest.fixture(scope="module", params=ARCHS)
def arch_trees(request):
    arch = request.param
    jcfg = jconfigs.get_config(arch)
    jparams = jax.eval_shape(functools.partial(jget_model(jcfg).init, jcfg),
                             jax.random.key(0))
    cfg = configs.get_config(arch)
    model = get_model(cfg).empty(cfg, device="meta")
    return arch, jparams, model


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_equal_reference(arch_trees, mesh_name):
    arch, jparams, model = arch_trees
    jmesh, mesh = _meshes(mesh_name)
    want = _ref_leaves(jshd.param_shardings(jparams, jmesh))
    shapes = _ref_leaves(jparams)
    got = shd.param_shardings(model, mesh)
    params = dict(model.named_parameters())
    assert len(got) == len(params)
    seen = set()
    for name, spec in got.items():
        key = tuple(p for p in name.split(".") if not p.isdigit())
        ref_leaf = shapes[key]
        stacked = len(ref_leaf.shape) - params[name].dim()
        assert stacked in (0, 1, 2)
        assert tuple(ref_leaf.shape[stacked:]) == tuple(params[name].shape)
        assert tuple(spec) == _norm(want[key].spec, len(ref_leaf.shape),
                                    stacked), (arch, name)
        seen.add(key)
    assert seen == set(shapes)         # every reference leaf is matched


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", SERVE)
def test_cache_specs_equal_reference(arch_trees, mesh_name, shape_name):
    arch = arch_trees[0]
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    shape = jconfigs.SHAPES[shape_name]
    jmesh, mesh = _meshes(mesh_name)
    b = shape.global_batch
    extra = jcfg.n_patches if jcfg.family == "vlm" else 0
    jcache = jax.eval_shape(lambda: jget_model(jcfg).init_cache(
        jcfg, b, shape.seq_len + extra))
    want = {k[-1]: v.spec for k, v in _ref_leaves(
        jshd.cache_shardings(jcache, jmesh, b)).items()}
    cache = get_model(cfg).init_cache(cfg, b, shape.seq_len + extra,
                                      device="meta")
    got = shd.cache_shardings(cache, mesh, b)
    assert set(got) == set(want)
    for name, spec in got.items():
        assert tuple(spec) == _norm(want[name]), (arch, name)
        if name != "pos":
            assert tuple(cache[name].shape) == tuple(jcache[name].shape)
            shd.shard_shape(cache[name].shape, spec, mesh)   # divisible


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_cache_spec_grid(mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    assert tuple(shd.batch_spec(mesh)) == _norm(jshd.batch_spec(jmesh))
    for kv in (1, 2, 4, 5, 8, 16, 32, 64):
        for b in (1, 2, 3, 32, 128, 256, 512):
            assert tuple(shd.cache_spec(mesh, kv, b)) == _norm(
                jshd.cache_spec(jmesh, kv, b)), (kv, b)


def test_long_500k_context_parallel():
    """Batch 1 cannot shard: the dp axes (and model, for 8 kv heads over
    16) move to the sequence dim of the k/v caches."""
    cfg = configs.get_config("zamba2-2.7b")
    mesh = make_production_mesh()
    cache = get_model(cfg).init_cache(cfg, 1, 524_288, device="meta")
    specs = shd.cache_shardings(cache, mesh, 1)
    seq = specs["k"][2]
    assert specs["k"][1] is None and "data" in seq
    assert shd.shard_shape(cache["k"].shape, specs["k"], mesh)[2] \
        == 524_288 // shd._axes_size(mesh, seq)


def test_production_meshes():
    m, mp = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (m.shape, m.size) == ({"data": 16, "model": 16}, 256)
    assert (mp.axis_names, mp.size) == (("pod", "data", "model"), 512)


def test_shard_shape():
    mesh = shd.AbstractMesh((2, 4), ("data", "model"))
    assert shd.shard_shape((8, 12, 3), shd.P("data", "model"), mesh) \
        == (4, 3, 3)
    assert shd.shard_shape((16,), shd.P(("data", "model")), mesh) == (2,)
    with pytest.raises(ValueError):
        shd.shard_shape((6, 3), shd.P(None, "model"), mesh)


def test_constrain_is_identity():
    x = torch.randn(2, 3, 4)
    assert shd.constrain(x, shd.DP_AXES, None, shd.TP_AXIS) is x
    for mode in ("seq", "d", "full_dp", "none"):
        assert shd.act_constrain(x, mode) is x
    logits = torch.randn(2, 2, 2, 3, 3)
    assert shd.attn_logits_constrain(logits) is logits
    with pytest.raises(ValueError):
        shd.constrain(x, None, None, None, None)
    with pytest.raises(ValueError):
        shd.attn_logits_constrain(x)

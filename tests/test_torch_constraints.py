"""The port's sharding-constraint hooks against the JAX package's
(``repro.sharding.constrain`` / ``act_constrain`` /
``attn_logits_constrain`` at the reference's 20 call sites).

The reference's calls are recorded by replacing
``jax.lax.with_sharding_constraint`` with a recorder that returns its
input, under ``jax.sharding.use_abstract_mesh``; each entry point is traced
(``make_jaxpr``) under ``disable_jit``, so a scanned layer body runs once
per layer, as the port runs its layers (``torch_parity``). For every arch
in ``ARCHS``, reduced, at B 2 × S 16, in forward, prefill, decode_step
and one train step, under a (2, 2) ("data", "model") and a (2, 2, 2)
("pod", "data", "model") abstract mesh, the port's records inside
``set_mesh`` equal the reference's call for call: shapes, dtypes (the
port's int64 indices as int32) and specs (each entry a tuple of names).
Also: ``attn_logits_constrain`` picks the reference's branch at shapes
that reach each of its four and at tp 1; inside a context every arch's
forward logits are bit-equal to those outside; the hooks return their
input; the context nests, is restored after an exception and is not seen
by another thread; a remat'd train step records what an un-remat'd one
does; the dry-run and ``inspect_cell`` count inside the cell's mesh and
their counts do not move. Every input comes from a numpy seed."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
import torch_parity as tp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import sharding as jshd  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import sharding as shd  # noqa: E402
from repro_torch.configs import Shape  # noqa: E402
from repro_torch.launch import dryrun, inspect_cell, roofline  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

ARCHS = sorted(jconfigs.ARCHS)


@pytest.fixture(scope="module")
def reference_records():
    """{(arch, mesh): the reference's records}, traced once per pair."""
    cache = {}

    def get(arch, mesh_name):
        if (arch, mesh_name) not in cache:
            with pytest.MonkeyPatch.context() as mp:
                cache[arch, mesh_name] = tp.reference_constraint_records(
                    arch, mesh_name, mp)
        return cache[arch, mesh_name]

    return get


@pytest.mark.parametrize("mesh_name", list(tp.CONSTRAINT_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_records_equal_reference(arch, mesh_name, reference_records):
    want = reference_records(arch, mesh_name)
    got = tp.port_constraint_records(arch, mesh_name)
    for entry in tp.ENTRY_POINTS:
        assert got[entry] == want[entry], (arch, mesh_name, entry)
    assert got["forward"] and got["train_step"]


def test_the_sites_the_records_reach(reference_records):
    """The comparison above reaches the hooks it is meant to: the GShard
    dispatch's eight sites (y_j once per k), the logits' group and kv
    branches, the ``pod`` axis filtered out on the (2, 2) mesh."""
    moe = reference_records("granite-moe-1b-a400m", "2x2")["forward"]
    cfg = jconfigs.reduced(jconfigs.get_config("granite-moe-1b-a400m"))
    per_layer = 1 + 2 + 7 + cfg.top_k   # logits, 2 act, the dispatch
    assert len(moe) == cfg.n_layers * per_layer
    specs = {r[2] for r in moe}
    assert (("data", "model"),) in specs           # gall without pod
    assert (("data",), ("model",)) in specs        # group over model / EP
    mha = reference_records("qwen1.5-4b", "2x2x2")["forward"]  # G 1, KV 4
    assert (("pod", "data"), None, ("model",)) in {r[2] for r in mha}


# ---------------------------------------------------------------------------
# attn_logits_constrain: the reference's preference order
# ---------------------------------------------------------------------------

LOGITS = {"group": (2, 4, 1, 8, 8), "kv": (2, 1, 4, 8, 8),
          "keys": (2, 3, 3, 8, 8), "dp_only": (2, 3, 3, 8, 6)}
LOGITS_MESHES = {"2x4": ((2, 4), ("data", "model")),
                 "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
                 "tp1": ((4, 1), ("data", "model")),
                 "no_model": ((4,), ("data",))}


def _reference_logits_record(shape, sizes, axes):
    calls = []

    def record(x, spec):
        calls.append((tuple(x.shape), str(x.dtype), tuple(spec)))
        return x

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "with_sharding_constraint", record)
        with jax.sharding.use_abstract_mesh(JAbstractMesh(sizes, axes)):
            jshd.attn_logits_constrain(
                jax.ShapeDtypeStruct(shape, np.float32))
    return tp.norm_records(calls)


@pytest.mark.parametrize("mesh_name", list(LOGITS_MESHES))
@pytest.mark.parametrize("case", list(LOGITS))
def test_attn_logits_branch_equals_reference(case, mesh_name):
    sizes, axes = LOGITS_MESHES[mesh_name]
    want = _reference_logits_record(LOGITS[case], sizes, axes)
    x = torch.zeros(LOGITS[case])
    with shd.set_mesh(shd.AbstractMesh(sizes, axes)) as ctx:
        assert shd.attn_logits_constrain(x) is x
    assert tp.norm_records(ctx.records) == want
    if "model" not in axes or dict(zip(axes, sizes))["model"] == 1:
        assert want == []                   # no model axis, or tp 1


def test_attn_logits_shapes_reach_every_branch():
    dp = ("data",)
    got = {case: _reference_logits_record(shape, (2, 4), ("data", "model"))
           for case, shape in LOGITS.items()}
    assert {case: recs[0][2] for case, recs in got.items()} == {
        "group": (dp, ("model",)), "kv": (dp, None, ("model",)),
        "keys": (dp, None, None, None, ("model",)), "dp_only": (dp,)}


# ---------------------------------------------------------------------------
# Identity: a context changes no number
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_equal_inside_a_context(arch):
    cfg, model = tp.port_model(arch, seed=3)
    mod = get_model(cfg)
    batch = tp.lm_batch(cfg, 3)
    outside = mod.forward(model, batch, cfg, device="cpu")
    mesh = shd.AbstractMesh(*tp.CONSTRAINT_MESHES["2x2x2"])
    with shd.set_mesh(mesh) as ctx:
        inside = mod.forward(model, batch, cfg, device="cpu")
    assert ctx.records and torch.equal(inside, outside)


def test_hooks_return_their_input():
    x = torch.randn(4, 6, 8)
    logits = torch.randn(2, 4, 2, 3, 6)
    mesh = shd.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    with shd.set_mesh(mesh) as ctx:
        assert shd.constrain(x, shd.DP_AXES, None, shd.TP_AXIS) is x
        for mode in ("seq", "d", "full_dp", "none"):
            assert shd.act_constrain(x, mode) is x
        assert shd.attn_logits_constrain(logits) is logits
        with pytest.raises(ValueError):
            shd.constrain(x, None, None, None, None)
        with pytest.raises(ValueError):
            shd.attn_logits_constrain(x)
    dp = ("pod", "data")
    assert [tuple(r) for r in ctx.records] == [
        ((4, 6, 8), "float32", shd.P(dp, None, "model")),
        ((4, 6, 8), "float32", shd.P(dp, "model")),
        ((4, 6, 8), "float32", shd.P(dp, None, "model")),
        ((4, 6, 8), "float32", shd.P(dp + ("model",))),
        ((4, 6, 8), "float32", shd.P(dp)),
        ((2, 4, 2, 3, 6), "float32", shd.P(dp, "model"))]


def test_context_nests_and_is_restored():
    outer_mesh = shd.AbstractMesh((2, 2), ("data", "model"))
    inner_mesh = shd.make_er_mesh(2, 1, devices=["cpu"] * 2)
    x = torch.zeros(2, 3)
    assert shd.get_mesh() is None
    with shd.set_mesh(outer_mesh) as outer:
        shd.constrain(x, shd.DP_AXES)
        with shd.set_mesh(inner_mesh) as inner:
            assert shd.get_mesh() is inner_mesh
            shd.constrain(x, shd.DP_AXES, shd.TP_AXIS)
            with shd.set_mesh(None) as none:
                assert none is None and shd.get_mesh() is None
                shd.constrain(x, shd.DP_AXES)
        assert shd.get_mesh() is outer_mesh
        with pytest.raises(RuntimeError):
            with shd.set_mesh(inner_mesh):
                raise RuntimeError("inside")
        assert shd.get_mesh() is outer_mesh
        shd.constrain(x, None, shd.TP_AXIS)
    assert shd.get_mesh() is None
    assert [r.spec for r in outer.records] == [shd.P("data"),
                                               shd.P(None, "model")]
    assert [r.spec for r in inner.records] == [shd.P("data", "model")]
    with pytest.raises(TypeError):
        with shd.set_mesh("16x16"):
            pass


def test_another_thread_sees_no_context():
    seen = []
    with shd.set_mesh(shd.AbstractMesh((2, 2), ("data", "model"))) as ctx:
        t = threading.Thread(target=lambda: seen.append(
            (shd.get_mesh(), shd.constrain(torch.zeros(2), shd.DP_AXES))))
        t.start()
        t.join()
    assert seen[0][0] is None and ctx.records == []


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-7b",
                                  "whisper-base", "zamba2-2.7b"])
def test_remat_records_one_call_per_forward(arch):
    """The recomputation in the backward pass records nothing: a train
    step with ``remat`` records what one without it does."""
    plain = tp.port_constraint_records(arch, "2x2")["train_step"]
    assert tp.port_constraint_records(
        arch, "2x2", remat=True)["train_step"] == plain


# ---------------------------------------------------------------------------
# The cell harness counts inside the cell's mesh
# ---------------------------------------------------------------------------

def _watch_analyze_cell(monkeypatch, mesh):
    seen = []
    real = roofline.analyze_cell

    def analyze_cell(cell, mesh_name):
        seen.append(shd.get_mesh() is mesh)
        return real(cell, mesh_name)

    monkeypatch.setattr(roofline, "analyze_cell", analyze_cell)
    return seen


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-2.7b"])
def test_dryrun_counts_inside_the_mesh(arch, monkeypatch):
    cfg = configs.reduced(configs.get_config(arch))
    mesh = shd.AbstractMesh((2, 2), ("data", "model"))
    shape = Shape("train", 32, 4, "train")
    cell = build_cell(cfg, shape, mesh, layer_unroll=1)
    outside, count = roofline.analyze_cell(cell, "2x2")
    with shd.set_mesh(mesh) as ctx:
        inside, count2 = roofline.analyze_cell(cell, "2x2")
    assert ctx.records and inside.row() == outside.row()
    assert (count2.ops, count2.peak_bytes) == (count.ops, count.peak_bytes)
    seen = _watch_analyze_cell(monkeypatch, mesh)
    dryrun.run_cell(cfg, shape, mesh, "2x2", extrapolate=False)
    assert seen == [True]


def test_inspect_cell_counts_inside_the_mesh(monkeypatch, capsys):
    from repro_torch.launch import mesh as lmesh

    mesh = lmesh.make_production_mesh()
    monkeypatch.setattr(lmesh, "make_production_mesh", lambda: mesh)
    seen = _watch_analyze_cell(monkeypatch, mesh)
    assert inspect_cell.main(["--arch", "smollm-360m", "--shape",
                              "decode_32k", "--layers", "1"]) in (0, None)
    assert seen == [True] and "== collectives ==" in capsys.readouterr().out

"""The port's LM serving path against the JAX package on the CPU, moe
family (granite-moe at ``reduced()`` size, f32, on the reference's
random-init params converted by ``convert.model_params_from``):
``prefill``, ``decode_step`` and greedy ``generate(max_new_tokens=5)``
give the reference's logits (atol 1e-4, rtol 1e-4) and tokens with
``moe_dispatch`` grouped (the reference's Pallas grouped matmul in
interpret mode) and gshard, on both of the port's attention routes; with
G = 1 the reference's ``attn_impl="pallas"`` is itself the oracle of the
port's kernel route; one MoE FFN at both tile heights."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402  (one torch thread per worker)
from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import config_from, model_params_from  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
GRANITE = "granite-moe-1b-a400m"


@pytest.mark.parametrize("dispatch", ["grouped", "gshard"])
def test_granite_serving_equals_reference(dispatch):
    jcfg = jconfigs.reduced(jconfigs.get_config(GRANITE)).replace(
        attn_impl="xla", moe_dispatch=dispatch)
    tree, batch, last, nxt, step, toks = tp.lm_reference(jcfg, seed=5)
    for attn in ("plain", "kernel"):
        cfg = configs.reduced(configs.get_config(GRANITE)).replace(
            attn_impl=attn, moe_dispatch=dispatch)
        got_last, got_step, got_toks = tp.lm_port(cfg, tree, batch, nxt)
        np.testing.assert_allclose(got_last, last, **TOL)
        np.testing.assert_allclose(got_step, step, **TOL)
        np.testing.assert_array_equal(got_toks, toks)


def test_granite_g1_matches_reference_flash_route():
    """With n_kv_heads = n_heads the reference's flash route pairs heads as
    its g-major route does, so the reference's ``attn_impl="pallas"``
    (interpret mode here) is itself the oracle of the port's kernel route."""
    jcfg = jconfigs.reduced(jconfigs.get_config(GRANITE)).replace(
        attn_impl="pallas", n_kv_heads=4, moe_dispatch="grouped")
    tree, batch, last, nxt, step, toks = tp.lm_reference(jcfg, seed=6)
    cfg = config_from(jcfg)
    assert cfg.attn_impl == "kernel"
    got_last, got_step, got_toks = tp.lm_port(cfg, tree, batch, nxt)
    np.testing.assert_allclose(got_last, last, **TOL)
    np.testing.assert_allclose(got_step, step, **TOL)
    np.testing.assert_array_equal(got_toks, toks)


@pytest.mark.parametrize("tokens", [512, 24])     # block_t 128 and 8
def test_grouped_experts_equal_reference_and_gshard(tokens):
    """One granite MoE FFN on the reference's weights: the port's grouped
    dispatch equals the reference's (Pallas grouped matmul, interpret mode)
    at both tile heights, and equals the port's gshard dispatch (the
    capacity is large enough to drop nothing)."""
    jcfg = jconfigs.reduced(jconfigs.get_config(GRANITE))
    params = jmoe.init(jcfg, jax.random.key(7))
    p1 = jax.tree.map(lambda a: a[0], params["layers"])
    x = np.random.default_rng(7).standard_normal(
        (tokens, jcfg.d_model)).astype(np.float32)
    w, ids, _ = jmoe._route(p1, jnp.asarray(x), jcfg)
    want = np.asarray(jmoe._experts_grouped(p1, jnp.asarray(x), w, ids, jcfg))
    cfg = configs.reduced(configs.get_config(GRANITE))
    model = model_params_from(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    p = model.layers[0]
    xt = torch.from_numpy(x)
    wt, idt, _ = moe._route(p, xt, cfg)
    np.testing.assert_array_equal(idt.numpy(), np.asarray(ids))
    np.testing.assert_allclose(wt.numpy(), np.asarray(w), **TOL)
    *_, bt = moe.grouped_layout(idt, cfg.num_experts)
    assert bt == (128 if tokens * cfg.top_k >= 128 * cfg.num_experts else 8)
    got = moe._experts_grouped(p, xt, wt, idt, cfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    gshard = moe._experts_gshard(p, xt, wt, idt, cfg)
    np.testing.assert_allclose(gshard.numpy(), want, **TOL)

"""The port's hybrid family (zamba2, ``repro_torch.models.zamba2``)
against the JAX package on the CPU at ``reduced()`` size (4 Mamba2
layers, the shared attention block after every 2), f32, on the
reference's random-init params converted by ``convert.model_params_from``
(its ``(n_super, every, …)`` blocks flattened): prefill, one decode step
(logits within atol 1e-4 / rtol 1e-4) and greedy ``generate`` (equal
tokens) on both attention routes of the shared block; tests/
test_arch_smoke.py's prefill/decode consistency (atol 2e-3, rtol 1e-2);
and a 512-token prompt, so that the SSD recurrence runs in chunks of 256
(under ``remat`` with autograd): prefill logits within 1e-4 and the loss
gradient of every parameter within atol 1e-5 / rtol 1e-3 of the
reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_parity as tp  # noqa: E402  (one torch thread per worker)
from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import get_model, zamba2  # noqa: E402

ARCH = "zamba2-2.7b"
TOL = dict(atol=1e-4, rtol=1e-4)


def _cfg(**over):
    return configs.reduced(configs.get_config(ARCH)).replace(**over)


@pytest.mark.parametrize("attn", ["plain", "kernel"])
def test_port_serving_equals_reference(attn):
    jcfg = jconfigs.reduced(jconfigs.get_config(ARCH))
    tree, batch, last, nxt, step, toks = tp.lm_reference(jcfg, seed=5)
    got_last, got_step, got_toks = tp.lm_port(_cfg(attn_impl=attn), tree,
                                              batch, nxt)
    np.testing.assert_allclose(got_last, last, **TOL)
    np.testing.assert_allclose(got_step, step, **TOL)
    np.testing.assert_array_equal(got_toks, toks)


@pytest.mark.parametrize("seed", [1, 2])
def test_prefill_decode_consistency(seed):
    cfg = _cfg()
    model = get_model(cfg).init(cfg, torch.Generator().manual_seed(seed),
                                device="cpu")
    tp.lm_consistency(cfg, model, seed)


def test_long_prompt_runs_the_chunked_scan():
    diff, grads = tp.lm_long_prompt(ARCH)
    assert diff <= 1e-4
    for name, (got, want) in grads.items():
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-3,
                                   err_msg=name)


def test_layout_and_cache():
    """One shared block (one parameter set), n_layers Mamba2 blocks, a KV
    cache per application; n_layers must be a multiple of the period."""
    cfg = _cfg()
    model = zamba2.empty(cfg, device="cpu")
    assert len(model.blocks) == cfg.n_layers
    assert sum(1 for n, _ in model.named_parameters()
               if n.startswith("shared_attn.")) == 9
    cache = zamba2.init_cache(cfg, 2, 24, device="cpu")
    n_sup = cfg.n_layers // cfg.shared_attn_every
    assert cache["k"].shape == (n_sup, 2, 24, cfg.n_kv_heads, cfg.hd)
    assert cache["ssm"].shape[:3] == (n_sup, cfg.shared_attn_every, 2)
    assert cache["ssm"].dtype == torch.float32
    with pytest.raises(ValueError, match="multiple of shared_attn_every"):
        zamba2.empty(cfg.replace(n_layers=5), device="cpu")

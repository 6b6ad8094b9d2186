"""The port's ssm family (rwkv6, ``repro_torch.models.rwkv6``) against
the JAX package on the CPU at ``reduced()`` size, f32, on the reference's
random-init params converted by ``convert.model_params_from``: prefill,
one decode step (logits within atol 1e-4 / rtol 1e-4) and greedy
``generate`` (equal tokens); tests/test_arch_smoke.py's prefill/decode
consistency (atol 2e-3, rtol 1e-2); and a 512-token prompt, so that the
WKV recurrence runs in chunks of 256 (under ``remat`` with autograd):
prefill logits within 1e-4 and the loss gradient of every parameter
within atol 1e-5 / rtol 1e-3 of the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_parity as tp  # noqa: E402  (one torch thread per worker)
from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import get_model, rwkv6  # noqa: E402

ARCH = "rwkv6-7b"
TOL = dict(atol=1e-4, rtol=1e-4)


def _cfg():
    return configs.reduced(configs.get_config(ARCH))


@pytest.mark.parametrize("seed", [5, 6])
def test_port_serving_equals_reference(seed):
    jcfg = jconfigs.reduced(jconfigs.get_config(ARCH))
    tree, batch, last, nxt, step, toks = tp.lm_reference(jcfg, seed=seed)
    got_last, got_step, got_toks = tp.lm_port(_cfg(), tree, batch, nxt)
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


def test_cache_is_constant_in_length():
    cfg = _cfg()
    short = rwkv6.init_cache(cfg, 2, 8, device="cpu")
    long = rwkv6.init_cache(cfg, 2, 100_000, device="cpu")
    assert {k: tuple(v.shape) for k, v in short.items() if k != "pos"} == \
        {k: tuple(v.shape) for k, v in long.items() if k != "pos"}
    assert short["wkv"].dtype == torch.float32
    assert short["wkv"].shape == (cfg.n_layers, 2, cfg.n_heads, cfg.hd,
                                  cfg.hd)

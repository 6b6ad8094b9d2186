"""The port's audio family (whisper, ``repro_torch.models.whisper``)
against the JAX package on the CPU at ``reduced()`` size (2 encoder and
2 decoder layers, 8 stub frames), f32, on the reference's random-init
params converted by ``convert.model_params_from``: prefill (encoder, cross
K/V, the prompt), one decode step (logits within atol 1e-4 / rtol 1e-4)
and greedy ``generate`` (equal tokens); tests/test_arch_smoke.py's
prefill/decode consistency (atol 2e-3, rtol 1e-2); and the kernel route,
which raises ``ValueError`` in the port as in the reference (a non-causal
encoder at a length that is not a multiple of the kv tile)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_parity as tp  # noqa: E402  (one torch thread per worker)
from repro import configs as jconfigs  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import get_model, whisper  # noqa: E402
from repro_torch.serve import generate  # noqa: E402

ARCH = "whisper-base"
TOL = dict(atol=1e-4, rtol=1e-4)


def _cfg(**over):
    return configs.reduced(configs.get_config(ARCH)).replace(**over)


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


def test_encoder_equals_reference():
    jcfg = jconfigs.reduced(jconfigs.get_config(ARCH))
    params = jget_model(jcfg).init(jcfg, jax.random.key(3))
    frames = tp.lm_batch(jcfg, 3)["frames"]
    want = jget_model(jcfg).encode(params, jnp.asarray(frames), jcfg)
    from repro_torch.convert import model_params_from
    model = model_params_from(jax.tree.map(np.asarray, params), _cfg(),
                              device="cpu")
    got = whisper.encode(model, frames, _cfg(), device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kernel_route_raises_as_the_reference():
    jcfg = jconfigs.reduced(jconfigs.get_config(ARCH)).replace(
        attn_impl="interpret")
    jbatch = {k: jnp.asarray(v) for k, v in tp.lm_batch(jcfg, 0).items()}
    params = jget_model(jcfg).init(jcfg, jax.random.key(0))
    with pytest.raises(ValueError, match="non-causal"):
        jget_model(jcfg).forward(params, jbatch, jcfg)
    cfg = _cfg(attn_impl="kernel")
    model = whisper.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = tp.lm_batch(cfg, 0)
    with pytest.raises(ValueError, match="non-causal"):
        whisper.forward(model, batch, cfg, device="cpu")
    with pytest.raises(ValueError, match="non-causal"):
        generate(model, cfg, batch, 2, device="cpu")


def test_cache_layout_and_frames_check():
    cfg = _cfg()
    cache = whisper.init_cache(cfg, 2, 24, device="cpu")
    assert cache["k"].shape == (cfg.n_layers, 2, 24, cfg.n_heads, cfg.hd)
    assert cache["xk"].shape == (cfg.n_layers, 2, cfg.n_audio_frames,
                                 cfg.n_heads, cfg.hd)
    model = whisper.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = tp.lm_batch(cfg, 0)
    batch["frames"] = batch["frames"][:, :-1]
    with pytest.raises(ValueError, match="frames"):
        whisper.prefill(model, batch, cfg, cache, device="cpu")

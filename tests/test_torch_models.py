"""The port's LM serving path against the JAX package on the CPU, dense
and vlm families: whole models at ``reduced()`` size, f32, on the
reference's random-init params converted by ``convert.model_params_from``.
``prefill``, ``decode_step`` and greedy ``generate(max_new_tokens=5)``
must give the reference's logits (atol 1e-4, rtol 1e-4) and tokens, for
smollm (G = 2), qwen3 (qk_norm), qwen1.5 (qkv_bias) and phi-3-vision
(vlm), on both of the port's attention routes, against the reference's
``attn_impl="xla"`` (its g-major attention). Also: configs and the
converter, the registry's six families, and the entry points' device
rule. The moe family is in tests/test_torch_models_moe.py, ssm / hybrid /
audio in tests/test_torch_models_{ssm,hybrid,audio}.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_parity as tp  # noqa: E402  (one torch thread per worker)
from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import config_from  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import generate  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-4b", "qwen1.5-4b",
                                  "phi-3-vision-4.2b"])
def test_port_serving_equals_reference(arch):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).replace(
        attn_impl="xla")
    tree, batch, last, nxt, step, toks = tp.lm_reference(jcfg, seed=5)
    for attn in ("plain", "kernel"):
        cfg = configs.reduced(configs.get_config(arch)).replace(
            attn_impl=attn)
        got_last, got_step, got_toks = tp.lm_port(cfg, tree, batch, nxt)
        np.testing.assert_allclose(got_last, last, **TOL)
        np.testing.assert_allclose(got_step, step, **TOL)
        np.testing.assert_array_equal(got_toks, toks)


def test_configs_and_converter_match_reference():
    assert sorted(configs.ARCHS) == sorted(jconfigs.ARCHS)
    for name, jcfg in jconfigs.ARCHS.items():
        for c, jc in ((configs.get_config(name), jcfg),
                      (configs.reduced(configs.get_config(name)),
                       jconfigs.reduced(jcfg))):
            assert c == config_from(jc)
            assert c.param_count() == jc.param_count()
            assert c.active_param_count() == jc.active_param_count()
    granite = configs.get_config("granite-moe-1b-a400m")
    assert granite.param_count() == 1_384_912_896
    assert granite.active_param_count() == 478_943_232
    assert config_from(jconfigs.ARCHS["llama3.2-3b"].replace(
        attn_impl="pallas")).attn_impl == "kernel"
    with pytest.raises(ValueError):
        configs.get_config("llama3.2-3b").replace(attn_impl="xla")


@pytest.mark.parametrize("family,arch", [("ssm", "rwkv6-7b"),
                                         ("hybrid", "zamba2-2.7b"),
                                         ("audio", "whisper-base")])
def test_later_families_raise(family, arch):
    """The families ported last are served (their modules are the
    reference's names); only an unknown family raises."""
    from repro.models import get_model as jget_model

    cfg = configs.get_config(arch)
    assert cfg.family == family
    mod = get_model(cfg)
    assert mod.__name__ == "repro_torch.models." + \
        jget_model(jconfigs.get_config(arch)).__name__.split(".")[-1]
    with pytest.raises(ValueError, match="unknown model family"):
        get_model(cfg.replace(family="rnn"))


def test_entry_points_need_a_card_or_cpu_and_sample_seeded():
    cfg = configs.reduced(configs.get_config("smollm-360m"))
    mod = get_model(cfg)
    model = mod.init(cfg, torch.Generator("cpu").manual_seed(0),
                     device="cpu")
    batch = tp.lm_batch(cfg, 1)
    if not torch.cuda.is_available():
        for call in (lambda: generate(model, cfg, batch, 2),
                     lambda: mod.init_cache(cfg, tp.LM_B, tp.LM_S),
                     lambda: mod.init(cfg, torch.Generator("cpu"))):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    runs = [generate(model, cfg, batch, 6, temperature=0.8, device="cpu",
                     generator=torch.Generator("cpu").manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (tp.LM_B, 6) and runs[0].dtype == torch.int32
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab
    assert generate(model, cfg, batch, 0, device="cpu").shape == (tp.LM_B, 0)

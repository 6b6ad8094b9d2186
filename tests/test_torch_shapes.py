"""The port's shape table against the JAX package's: ``SHAPES``,
``applicable`` and ``skip_reason`` for all 10 archs × 4 shapes, and
``input_specs`` (meta tensors) against the reference's
``ShapeDtypeStruct``s: the same names, shapes and dtypes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402

CELLS = [(a, s) for a in sorted(jconfigs.ARCHS) for s in jconfigs.SHAPES]


def test_shape_table_equals_reference():
    assert list(configs.SHAPES) == list(jconfigs.SHAPES)
    for name, shape in configs.SHAPES.items():
        ref = jconfigs.SHAPES[name]
        assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) \
            == (ref.name, ref.seq_len, ref.global_batch, ref.kind)
    assert shapes.SHAPES is configs.SHAPES
    assert sorted(configs.ARCHS) == sorted(jconfigs.ARCHS)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_applicability_equals_reference(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    s, js = configs.SHAPES[shape], jconfigs.SHAPES[shape]
    assert configs.skip_reason(cfg, s) == jconfigs.skip_reason(jcfg, js)
    assert configs.applicable(cfg, s) == jconfigs.applicable(jcfg, js)
    # long_500k runs only on the sub-quadratic families
    assert configs.applicable(cfg, s) == (
        shape != "long_500k" or cfg.family in ("ssm", "hybrid"))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_reference(arch, shape):
    got = configs.input_specs(configs.get_config(arch),
                              configs.SHAPES[shape])
    want = jconfigs.input_specs(jconfigs.get_config(arch),
                                jconfigs.SHAPES[shape])
    assert list(got) == list(want)
    for k, ref in want.items():
        t = got[k]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref.shape), k
        assert str(t.dtype).replace("torch.", "") == np.dtype(ref.dtype).name


def test_input_specs_token_dtype():
    cfg, shape = configs.get_config("qwen3-4b"), configs.SHAPES["train_4k"]
    got = configs.input_specs(cfg, shape, dtype=torch.int64)
    want = jconfigs.input_specs(jconfigs.get_config("qwen3-4b"),
                                jconfigs.SHAPES["train_4k"], dtype=jnp.int32)
    assert {k: v.dtype for k, v in got.items()} == {
        k: torch.int64 for k in want}

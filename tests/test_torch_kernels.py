"""The plain PyTorch versions of the port's catalog kernels against the
JAX package's ``kernels/ref.py`` oracles, on dyadic inputs (integers ×
2⁻³) where every dot is exact in f32, so masks, packed ids and counts must
be equal bit for bit: the shape/dtype sweep of tests/test_kernels.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from torch_parity import DTYPES, SHAPES, catalog, dyadic  # noqa: E402


def _port(x, dtype="float32"):
    return convert.to_device(x, "cpu", getattr(torch, dtype))


def _jax(x, dtype="float32"):
    return jnp.asarray(x, getattr(jnp, dtype))



@pytest.mark.parametrize("m,n,d", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bm,bn", [(32, 32), (64, 32)])
def test_plain_equals_jax_ref_on_dyadic_inputs(m, n, d, dtype, bm, bn):
    rng = np.random.default_rng(m * 7 + d)
    a, b = dyadic(rng, m, d), dyadic(rng, n, d)
    cat = catalog(rng, m, n, bm, bn)
    kw = dict(threshold=0.5, block_m=bm, block_n=bn)
    got = ref.pair_scores_catalog_ref(_port(a, dtype), _port(b, dtype),
                                      _port(cat), **kw)
    want = jref.pair_scores_catalog_ref(_jax(a, dtype), _jax(b, dtype),
                                        jnp.asarray(cat), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[-3:].any()                       # zero pad rows
    wp, wc = jref.pair_scores_catalog_compact_ref(
        _jax(a, dtype), _jax(b, dtype), jnp.asarray(cat), capacity=bm * bn,
        **kw)
    for cap in (bm * bn, 32, 4):
        # a capacity-cap packing is the first cap slots of the full one
        gp, gc = ref.pair_scores_catalog_compact_ref(
            _port(a, dtype), _port(b, dtype), _port(cat), capacity=cap, **kw)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp)[:, :cap])

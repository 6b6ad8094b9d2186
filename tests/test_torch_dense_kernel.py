"""The port's dense ``pair_scores`` on the CPU against the JAX package: the
plain version (``ops.pair_scores`` on CPU tensors, ``ref.pair_scores_ref``)
against the Pallas kernel in interpret mode and against its ``ref`` oracle,
over the shape/dtype/triangular sweep and the block sizes of
tests/test_kernels.py, at its tolerances (1e-5 f32, 2e-2 bf16); on dyadic
inputs, bit for bit. The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_gpu.py, chip_smoke.py phase D)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops, pair_sim, ref  # noqa: E402
from torch_parity import DTYPES, SHAPES, dyadic, unit  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# The widths and sizes the bf16 wgmma + TMA route serves on the card:
# ragged d (8, 40, 72), M or N below one tile.
TMA_WIDTHS = [(12, 36, 8), (200, 136, 40), (96, 20, 72), (300, 260, 72)]


def _port(x, dtype="float32"):
    return convert.to_device(x, "cpu", getattr(torch, dtype))


def _jax(x, dtype="float32"):
    return jnp.asarray(x, getattr(jnp, dtype))


@pytest.mark.parametrize("m,n,d", SHAPES + TMA_WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("triangular", [False, True])
def test_plain_equals_pallas_interpret_and_ref(m, n, d, dtype, triangular):
    if triangular and m != n:
        n = m
    rng = np.random.default_rng(m * 3 + d)
    a = unit(rng, m, d)
    b = a if triangular else unit(rng, n, d)
    kw = dict(threshold=0.3, triangular=triangular)
    got = ops.pair_scores(_port(a, dtype), _port(b, dtype), impl="auto",
                          **kw)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    plain = ref.pair_scores_ref(_port(a, dtype), _port(b, dtype), **kw)
    assert torch.equal(got, plain)
    for want in (jops.pair_scores(_jax(a, dtype), _jax(b, dtype),
                                  impl="interpret", **kw),
                 jref.pair_scores_ref(_jax(a, dtype), _jax(b, dtype), **kw)):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])
    if triangular:
        assert not got.tril().any()


@pytest.mark.parametrize("block", [64, 128])
def test_block_sizes(block):
    a = unit(np.random.default_rng(block), 192, 64)
    got = ops.pair_scores(_port(a), _port(a), threshold=0.5,
                          triangular=True, block_m=block, block_n=block)
    want = jops.pair_scores(_jax(a), _jax(a), threshold=0.5,
                            triangular=True, block_m=block, block_n=block,
                            impl="interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("triangular", [False, True])
def test_dyadic_inputs_are_bit_exact(dtype, triangular):
    """Integers × 2⁻³: every dot is exact in f32 (and every value in bf16),
    so the plain version equals the Pallas kernel exactly, ties at the
    threshold included."""
    rng = np.random.default_rng(9)
    a, b = dyadic(rng, 150, 48), dyadic(rng, 150, 48)
    kw = dict(threshold=0.5, triangular=triangular)
    got = ops.pair_scores(_port(a, dtype), _port(b, dtype), **kw)
    want = jops.pair_scores(_jax(a, dtype), _jax(b, dtype), block_m=64,
                            block_n=64, impl="interpret", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 0.5).any()              # ties at the threshold are kept


def test_cpu_tensors_run_the_plain_version_and_cuda_raises():
    rng = np.random.default_rng(4)
    a = _port(unit(rng, 40, 16))
    ops.reset_launch_counts()
    ops.pair_scores(a, a, threshold=0.1, impl="auto")
    ops.pair_scores(a, a, threshold=0.1, impl="torch")
    assert ops.launch_counts()["pair_scores"] == 0
    with pytest.raises(ValueError):
        ops.pair_scores(a, a, impl="cuda")
    with pytest.raises(ValueError):          # the wrapper takes CUDA only
        pair_sim.pair_scores(a, a)
    with pytest.raises(ValueError):          # JAX route names are refused
        ops.pair_scores(a, a, impl="interpret")

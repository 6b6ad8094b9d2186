"""The plain versions of the port's LM kernels against the JAX package on
the CPU: ``ops.attention`` vs the Pallas flash kernel (interpret mode) and
``ref.attention_ref``, ``ops.grouped_matmul`` vs the Pallas grouped
matmul (interpret mode) and ``ref.grouped_matmul_ref``, at the sweep
shapes of tests/test_kernels.py and its tolerances (flash 5e-4 f32 /
3e-2 bf16, grouped 1e-4 f32 / 5e-2 bf16); the port's ``gqa_attention``
routes vs the reference's ``impl="xla"``; and the reference's head-layout
mismatch between its ``"xla"`` and ``"interpret"`` routes, which the port
does not copy."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.grouped_mm import pad_groups as jpad_groups  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import flash_attention, grouped_mm, ops, ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

FLASH_TOL = {"float32": 5e-4, "bfloat16": 3e-2}
GROUPED_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _pair(rng, shape, dtype, scale=1.0):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(x, getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,h,kvh,s,d", [(1, 4, 4, 128, 32),
                                         (2, 4, 2, 256, 32),
                                         (1, 8, 1, 512, 64),
                                         (2, 2, 2, 384, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_pallas_and_ref(b, h, kvh, s, d, dtype):
    rng = np.random.default_rng(s + h)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng, shape, dtype) for shape in
        ((b, h, s, d), (b, kvh, s, d), (b, kvh, s, d)))
    got = ops.attention(qt, kt, vt, causal=True, block_q=128, block_k=128)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    pallas = jops.attention(qj, kj, vj, causal=True, block_q=128,
                            block_k=128, impl="interpret")
    _close(got, pallas, FLASH_TOL[dtype])
    _close(got, jref.attention_ref(qj, kj, vj, causal=True),
           FLASH_TOL[dtype])


def test_attention_noncausal_and_its_contract():
    rng = np.random.default_rng(7)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng, (1, 2, 256, 32), "float32") for _ in range(3))
    got = ops.attention(qt, kt, vt, causal=False, block_q=128, block_k=128)
    want = jops.attention(qj, kj, vj, causal=False, block_q=128,
                          block_k=128, impl="interpret")
    _close(got, want, FLASH_TOL["float32"])
    # S = 200 pads to the 128-row kv tile: the reference kernel raises for
    # a non-causal call, and so does the port on every route
    q = qt[:, :, :200].contiguous()
    with pytest.raises(ValueError, match="non-causal"):
        jops.attention(qj[:, :, :200], kj[:, :, :200], vj[:, :, :200],
                       causal=False, block_q=128, block_k=128,
                       impl="interpret")
    with pytest.raises(ValueError, match="non-causal"):
        ops.attention(q, q, q, causal=False, block_q=128, block_k=128)
    with pytest.raises(ValueError, match="non-causal"):
        flash_attention.flash_attention(q, q, q, causal=False, block_q=128,
                                        block_k=128)
    with pytest.raises(ValueError, match="CUDA"):   # the kernel is card-only
        flash_attention.flash_attention(q, q, q, causal=True)
    assert flash_attention.kv_tiles(200, 128, 128) == (128, 128, 256)
    assert flash_attention.kv_tiles(1000) == (512, 512, 1024)
    assert flash_attention.kv_tiles(300) == (128, 128, 384)


@pytest.mark.parametrize("t,d,e,f,bt", [(256, 32, 2, 48, 128),
                                        (384, 64, 3, 128, 128),
                                        (64, 16, 8, 24, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_plain_matches_pallas_and_ref(t, d, e, f, bt, dtype):
    rng = np.random.default_rng(t + e)
    xj, xt = _pair(rng, (t, d), dtype)
    te = np.sort(rng.integers(0, e, t // bt)).astype(np.int32)
    wj, wt = _pair(rng, (e, d, f), dtype, scale=0.1)
    got = ops.grouped_matmul(xt, torch.from_numpy(te), wt, block_t=bt)
    assert got.dtype == xt.dtype and got.shape == (t, f)
    pallas = jops.grouped_matmul(xj, jnp.asarray(te), wj, block_t=bt,
                                 impl="interpret")
    _close(got, pallas, GROUPED_TOL[dtype])
    _close(got, jref.grouped_matmul_ref(xj, jnp.asarray(te), wj, block_t=bt),
           GROUPED_TOL[dtype])


def _late_rows_with_tile_fault(q, k, v, fault, tile, bk=128):
    """attention_ref's last 128 causal rows when the kernel's kv tile
    ``tile`` is lost (never read) or repeated (tile 0 read in its place):
    what a fault in the K/V ring would give."""
    s = q.shape[-2]
    k, v = k.clone(), v.clone()
    if fault == "repeated":
        k[:, :, tile * bk:(tile + 1) * bk] = k[:, :, :bk]
        v[:, :, tile * bk:(tile + 1) * bk] = v[:, :, :bk]
    logits = q[:, :, -128:].float() @ k.float().transpose(-1, -2) \
        * q.shape[-1] ** -0.5
    dead = torch.arange(s) > torch.arange(s - 128, s)[:, None]
    if fault == "lost":
        dead[:, tile * bk:(tile + 1) * bk] = True
    p = torch.softmax(logits.masked_fill(dead, -1e30), -1)
    return (p @ v.float()).to(q.dtype)


@pytest.mark.parametrize("fault", ["lost", "repeated"])
@pytest.mark.parametrize("tile", [1, 14])
def test_band_rel_err_passes_rounding_and_flags_a_kv_tile_fault(fault,
                                                                tile):
    """The band check of the flash kernel (``ref.band_rel_err`` within
    ``ATTENTION_BAND_TOL``) at granite's S 2,048, D 64, bf16: the kernel's
    own roundings (p to bf16 before p·v, the output to bf16) stay inside
    it, and one lost or repeated 128-row kv tile of the last q tile does
    not."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 2048, 64))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    want = ref.attention_ref(q, k, v)
    # the kernel's rounding: unnormalised p in bf16, l in f32
    logits = q.float() @ k.float().transpose(-1, -2) * 64 ** -0.5
    logits = logits.masked_fill(
        torch.ones(2048, 2048, dtype=torch.bool).triu(1), -1e30)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    rounded = ((e.bfloat16().float() @ v.float()) / e.sum(-1, keepdim=True)
               ).bfloat16()
    assert ref.band_rel_err(rounded, want) <= \
        ref.ATTENTION_BAND_TOL["bfloat16"]
    faulty = want.clone()
    faulty[:, :, -128:] = _late_rows_with_tile_fault(q, k, v, fault, tile)
    assert ref.band_rel_err(faulty, want) > \
        4 * ref.ATTENTION_BAND_TOL["bfloat16"]


@pytest.mark.parametrize("d", flash_attention.HEAD_DIMS)
def test_flash_smem_model_fits_every_head_dim(d):
    """One block of either flash kernel fits the 227 KB a block may use at
    every head dim it is built for; bf16 holds two 128-row q tiles, a
    3-stage ring of K and V tiles (128 rows, 64 at D = 128) and its 13
    mbarriers past 1 KB of alignment."""
    from repro_torch.kernels.pair_sim import SMEM_BUDGET_BYTES
    for bf16 in (True, False):
        assert 0 < flash_attention.smem_bytes(d, bf16) <= SMEM_BUDGET_BYTES
    block_k = 64 if d == 128 else 128
    assert flash_attention.smem_bytes(d, True) == (
        1024 + 2 * d * (2 * 128 + 6 * block_k) + 8 * 13)


def test_grouped_contract_and_pad_groups():
    x = torch.zeros((60, 16))
    w = torch.zeros((2, 16, 8))
    with pytest.raises(ValueError, match="block_t"):
        ops.grouped_matmul(x, torch.zeros(8, dtype=torch.int32), w, block_t=8)
    with pytest.raises(ValueError, match="CUDA"):   # the kernel is card-only
        grouped_mm.grouped_matmul(x[:56], torch.zeros(7, dtype=torch.int32),
                                  w, block_t=8)
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((37, 16)).astype(np.float32)
    sizes = [5, 0, 20, 12]
    gj, tej, tmj = jpad_groups(jnp.asarray(xs), sizes, block_t=8)
    gt, tet, tmt = grouped_mm.pad_groups(torch.from_numpy(xs), sizes,
                                         block_t=8)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(tet.numpy(), np.asarray(tej))
    np.testing.assert_array_equal(tmt, tmj)


def _qkv(rng, b, s, h, kv, d):
    return [_pair(rng, shape, "float32") for shape in
            ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 2)])
def test_gqa_attention_routes_match_reference_xla(h, kv):
    rng = np.random.default_rng(h * 10 + kv)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, 40, h, kv, 16)
    want = jlayers.gqa_attention(qj, kj, vj, causal=True, impl="xla")
    for impl in ("plain", "kernel"):
        got = layers.gqa_attention(qt, kt, vt, causal=True, impl=impl)
        _close(got, want, 5e-4)


def test_reference_head_layout_mismatch_is_not_copied():
    """The reference's ``impl="interpret"`` (its flash kernel) pairs query
    head h with KV head h // G while its ``impl="xla"`` path pairs h with
    h % KV (g-major): at G = 2 they disagree on the heads where the two
    pairings differ. The port's two routes agree with each other and with
    the reference's ``"xla"`` route."""
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 1, 128, 4, 2, 16)
    xla = np.asarray(jlayers.gqa_attention(qj, kj, vj, impl="xla"))
    flash = np.asarray(jlayers.gqa_attention(qj, kj, vj, impl="interpret"))
    per_head = np.abs(xla - flash).max(axis=(0, 1, 3))
    assert per_head[0] < 1e-5 and per_head[3] < 1e-5   # h // 2 == h % 2
    assert per_head[1] > 0.1 and per_head[2] > 0.1     # the pairings differ
    plain = layers.gqa_attention(qt, kt, vt, impl="plain")
    kernel = layers.gqa_attention(qt, kt, vt, impl="kernel")
    assert torch.allclose(plain, kernel, rtol=0, atol=1e-6)
    _close(plain, xla, 5e-4)

"""Card tests of the port: the CUDA kernels (catalog, flash attention,
grouped matmul) against their plain PyTorch versions, and ``run_er`` on
the card against ``run_er`` on the CPU. Marked ``gpu``; each test asks the
``cuda`` fixture for the card and skips without one. Run them on the card
with ``pytest -m gpu``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import compute_bdm, plan_pair_range, plan_sorted_neighborhood  # noqa: E402
from repro_torch.er import ERConfig, make_products, run_er  # noqa: E402
from repro_torch.er.compiler import cross_job, lower, plan_to_job  # noqa: E402
from repro_torch.kernels import (build, flash_attention, grouped_mm, ops,  # noqa: E402
                                 pair_sim, ref)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m gpu on the H100")
    return torch.device("cuda")


def _dyadic(n, d, seed):
    """Rows of integers × 2⁻³ in [−0.5, 0.5]: every partial dot is exact in
    f32 (and the values exact in bf16), so kernel and plain version must
    agree bit for bit, ties at the threshold included."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-4, 5, (n, d)) / 8.0).astype(np.float32)


def _catalogs(bm, bn):
    sizes = np.array([150, 37, 80, 1, 9, 300], np.int64)
    n = int(sizes.sum())
    bdm = compute_bdm(np.repeat(np.arange(sizes.size), sizes),
                      np.zeros(n, np.int64), sizes.size, 1)
    pr = lower(plan_to_job(plan_pair_range(bdm, 5)), bm, bn).tiles
    sn = lower(plan_to_job(plan_sorted_neighborhood(n, 40, 3)), bm, bn).tiles
    cross = lower(cross_job(n, 70, 2), bm, bn).tiles
    pad = np.zeros((5, pair_sim.NCOLS), np.int32)
    return n, np.concatenate([pr, sn, pad]), cross


def test_build_and_smem_model(cuda):
    build.build_all()
    print(build.BUILD_LOG)
    lib = pair_sim._lib()
    for bm, bn in pair_sim.GEOMETRY_LATTICE:
        assert lib.pair_sim_smem_bytes(bm, bn) == \
            pair_sim.catalog_smem_bytes(bm, bn)


@pytest.mark.parametrize("bm,bn", pair_sim.GEOMETRY_LATTICE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 200])
def test_kernels_equal_plain_on_dyadic_inputs(cuda, bm, bn, dtype, d):
    n, tiles, cross = _catalogs(bm, bn)
    dt = getattr(torch, dtype)
    f = torch.from_numpy(_dyadic(n, d, 0)).to(cuda, dt)
    q = torch.from_numpy(_dyadic(70, d, 1)).to(cuda, dt)
    for a, b, cat in ((f, f, tiles), (f, q, cross)):
        cat = torch.from_numpy(cat).to(cuda)
        for cap in (bm * bn, 32, 4):
            got = ops.pair_scores_catalog_compact(
                a, b, cat, threshold=0.5, block_m=bm, block_n=bn,
                capacity=cap, impl="cuda")
            want = ref.pair_scores_catalog_compact_ref(
                a, b, cat, threshold=0.5, block_m=bm, block_n=bn,
                capacity=cap)
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[0], want[0])
        got = ops.pair_scores_catalog(a, b, cat, threshold=0.5, block_m=bm,
                                      block_n=bn, impl="cuda")
        want = ref.pair_scores_catalog_ref(a, b, cat, threshold=0.5,
                                           block_m=bm, block_n=bn)
        assert torch.equal(got, want)
    torch.cuda.synchronize()


def test_wrapper_raises_before_launch(cuda):
    f = torch.zeros((64, 32), device=cuda)
    cat = torch.zeros((1, pair_sim.NCOLS), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pair_sim.pair_scores_catalog(f, f, cat, block_m=16, block_n=16)
    with pytest.raises(ValueError):
        pair_sim.pair_scores_catalog(f.double(), f.double(), cat)
    with pytest.raises(ValueError):
        pair_sim.pair_scores_catalog(f, f, cat.cpu())


@pytest.mark.parametrize("strategy", ["basic", "block_split", "pair_range",
                                      "sorted_neighborhood"])
def test_run_er_on_card_equals_cpu(cuda, strategy):
    ds = make_products(1500, seed=3)
    titles = list(ds.titles)
    titles[::97] = ["" for _ in titles[::97]]          # key-less entities
    cfg = dict(strategy=strategy, r=8, m=4, feature_dim=128, max_len=48)
    ops.reset_launch_counts()
    got = run_er(titles, ERConfig(**cfg), device="cuda")
    assert ops.launch_counts()["pair_scores_catalog_compact"] > 0
    want = run_er(titles, ERConfig(**cfg), device="cpu")
    assert got.matches == want.matches
    assert got.total_pairs == want.total_pairs
    ref_run = run_er(titles, ERConfig(executor="reference", **cfg),
                     device="cuda")
    assert ref_run.matches == got.matches


# ---------------------------------------------------------------------------
# LM serving kernels: tolerances of the JAX package's own kernel tests
# (tests/test_kernels.py: flash 5e-4 f32 / 3e-2 bf16, grouped 1e-4 f32 /
# 5e-2 bf16)
# ---------------------------------------------------------------------------

FLASH_TOL = {"float32": 5e-4, "bfloat16": 3e-2}
GROUPED_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _normal(shape, seed, dtype, device, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(device, getattr(torch, dtype))


@pytest.mark.parametrize("b,h,kvh,s,d,causal", [
    (8, 16, 8, 2048, 64, True),      # granite prefill
    (2, 16, 8, 1000, 64, True),      # ragged S
    (1, 8, 2, 300, 16, True), (2, 4, 4, 257, 32, True),
    (1, 4, 1, 512, 128, True),       # G = 4
    (1, 4, 2, 256, 64, False), (1, 2, 2, 1024, 128, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_equals_plain(cuda, b, h, kvh, s, d, causal, dtype):
    q = _normal((b, h, s, d), 1, dtype, cuda)
    k = _normal((b, kvh, s, d), 2, dtype, cuda)
    v = _normal((b, kvh, s, d), 3, dtype, cuda)
    got = ops.attention(q, k, v, causal=causal, impl="cuda")
    want = ops.attention(q, k, v, causal=causal, impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= FLASH_TOL[dtype], err


def _skewed_layout(t_tokens, e, bt, seed, device):
    """Expert-sorted rows for skewed group sizes (some experts empty),
    tile-aligned by pad_groups."""
    rng = np.random.default_rng(seed)
    sizes = rng.multinomial(t_tokens, rng.dirichlet(np.full(e, 0.3)))
    x = _normal((t_tokens, 8), seed, "float32", "cpu")
    _, te, token_map = grouped_mm.pad_groups(x, sizes, block_t=bt)
    return te.to(device), token_map


@pytest.mark.parametrize("t,d,e,f,bt", [
    (16384, 1024, 32, 512, 128), (64, 1024, 32, 512, 8),
    (64, 512, 32, 1024, 8), (700, 40, 5, 48, 128), (50, 24, 3, 20, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_kernel_equals_plain(cuda, t, d, e, f, bt, dtype):
    te, token_map = _skewed_layout(t, e, bt, 4, cuda)
    tp = token_map.shape[0]
    x = _normal((tp, d), 5, dtype, cuda)
    x[torch.from_numpy(token_map < 0).to(cuda)] = 0    # padding rows
    w = _normal((e, d, f), 6, dtype, cuda, scale=d ** -0.5)
    got = ops.grouped_matmul(x, te, w, block_t=bt, impl="cuda")
    want = ops.grouped_matmul(x, te, w, block_t=bt, impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == (tp, f)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= GROUPED_TOL[dtype], err
    assert not got[torch.from_numpy(token_map < 0).to(cuda)].any()


def test_lm_wrappers_raise_before_launch(cuda):
    q = torch.zeros((1, 4, 64, 96), device=cuda)
    with pytest.raises(ValueError):       # head dim 96 is not built
        flash_attention.flash_attention(q, q, q)
    q = torch.zeros((1, 4, 200, 64), device=cuda)
    with pytest.raises(ValueError):       # non-causal ragged S
        flash_attention.flash_attention(q, q, q, causal=False)
    x = torch.zeros((64, 16), device=cuda)
    w = torch.zeros((2, 16, 8), device=cuda)
    te = torch.zeros((4,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):       # block_t 16 is not built
        grouped_mm.grouped_matmul(x, te, w, block_t=16)
    with pytest.raises(ValueError):       # T % block_t != 0
        grouped_mm.grouped_matmul(x[:60], te, w, block_t=8)


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m"])
def test_generate_on_card_equals_cpu(cuda, arch):
    """A reduced f32 model on the kernel route (flash; grouped for moe)
    gives the CPU's plain-version logits and greedy tokens."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.serve import generate, make_prefill

    cfg = reduced(get_config(arch)).replace(attn_impl="kernel",
                                            moe_dispatch="grouped")
    mod = get_model(cfg)
    cpu = mod.init(cfg, torch.Generator("cpu").manual_seed(0), device="cpu")
    card = mod.empty(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 300))}
    ops.reset_launch_counts()
    got = generate(card, cfg, batch, 6)
    assert ops.launch_counts()["flash_attention"] > 0
    if cfg.family == "moe":
        assert ops.launch_counts()["grouped_matmul"] > 0
    want = generate(cpu, cfg, batch, 6, device="cpu")
    assert torch.equal(got.cpu(), want)
    logits = make_prefill(cfg)(card, batch, mod.init_cache(cfg, 2, 301))[0]
    ref_logits = make_prefill(cfg, device="cpu")(
        cpu, batch, mod.init_cache(cfg, 2, 301, device="cpu"))[0]
    assert torch.allclose(logits.cpu(), ref_logits, atol=2e-3, rtol=1e-2)

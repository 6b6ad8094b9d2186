"""Card tests of the port: the CUDA kernels (catalog, flash attention,
grouped matmul) against their plain PyTorch versions, ``run_er`` on
the card against ``run_er`` on the CPU, the LM families' serving and
train step, and the cell harness's cells, on the card against the CPU. Marked ``gpu``; each test asks the
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
    flib = flash_attention._lib()
    for d in flash_attention.HEAD_DIMS:
        for bf16 in (True, False):
            assert flib.flash_attention_smem_bytes(d, int(bf16)) == \
                flash_attention.smem_bytes(d, bf16)
    dlib = pair_sim._dense_lib()
    for bm, bn in pair_sim.GEOMETRY_LATTICE:
        assert dlib.dense_scores_smem_bytes(bm, bn) == (
            pair_sim.dense_tma_smem_bytes(bm, bn) if bm >= 64 else -1)
    glib = grouped_mm._lib()
    for i, kernel in enumerate(grouped_mm.KERNELS):
        assert glib.grouped_mm_smem_bytes(i) == grouped_mm.smem_bytes(kernel)
    assert glib.grouped_mm_smem_bytes(len(grouped_mm.KERNELS)) == -1


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


def _mid_tile_catalog(n_a, n_b, bm, bn, seed):
    """Entries whose validity windows start and end inside their tiles,
    with random triangles, corner cuts and SN bands (some entries without
    any), plus zero pad rows."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(48):
        at = int(rng.integers(0, -(-n_a // bm)))
        bt = int(rng.integers(0, -(-n_b // bn)))
        r0 = at * bm + int(rng.integers(0, bm))
        c0 = bt * bn + int(rng.integers(0, bn))
        r1 = min(r0 + int(rng.integers(1, bm)), (at + 1) * bm)
        c1 = min(c0 + int(rng.integers(1, bn)), (bt + 1) * bn)
        cuts = rng.random() < 0.5
        lb = (r0 + int(rng.integers(0, bm // 2)), c0 + int(
            rng.integers(0, bn // 2))) if cuts else (-1, -1)
        ub = (r1 - int(rng.integers(0, bm // 2)), c1 - int(
            rng.integers(0, bn // 2))) if cuts else (2 ** 30, 2 ** 30)
        band = int(rng.integers(1, 2 * bn)) if rng.random() < 0.3 else 0
        rows.append([at, bt, r0, r1, c0, c1, int(rng.random() < 0.3),
                     *lb, *ub, band, 0])
    rows += [[0] * pair_sim.NCOLS] * 3
    return np.asarray(rows, np.int32)


@pytest.mark.parametrize("bm,bn", [(32, 256), (256, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [40, 300])
def test_compact_kernel_ragged_d_mid_tile_windows(cuda, bm, bn, dtype, d):
    """d not a multiple of the 32-column chunk, feature matrices whose row
    counts are not multiples of the tile, and windows that start mid-tile:
    bit for bit against the plain version at three capacities."""
    dt = getattr(torch, dtype)
    a = torch.from_numpy(_dyadic(700, d, 2)).to(cuda, dt)
    b = torch.from_numpy(_dyadic(333, d, 3)).to(cuda, dt)
    for x, y in ((a, a), (a, b)):
        cat = torch.from_numpy(_mid_tile_catalog(
            x.shape[0], y.shape[0], bm, bn, d)).to(cuda)
        for cap in (bm * bn, 64, 3):
            got = ops.pair_scores_catalog_compact(
                x, y, cat, threshold=0.25, block_m=bm, block_n=bn,
                capacity=cap, impl="cuda")
            want = ref.pair_scores_catalog_compact_ref(
                x, y, cat, threshold=0.25, block_m=bm, block_n=bn,
                capacity=cap)
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[0], want[0])
        assert int(want[1].sum()) > 0
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
    (1, 4, 2, 256, 64, False), (1, 2, 2, 1024, 128, False),
    # edges of the 128-row q and kv tiles: S below one tile, one past a
    # tile, a single row; D = 128 (two TMA boxes a row) with G = 4
    (1, 4, 2, 40, 32, True), (2, 4, 2, 129, 64, True),
    (2, 4, 2, 1, 64, True), (1, 8, 2, 2048, 128, True),
    # head dims 80 and 96 (a second 64-column box zero-filled past D):
    # ragged S, causal and not, G = 1 and 2; phi-3-vision's prefill shape
    (2, 4, 4, 1000, 96, True), (1, 8, 4, 333, 80, True),
    (1, 4, 2, 1024, 96, False), (2, 4, 4, 256, 80, False),
    (2, 4, 2, 129, 96, True), (1, 32, 32, 1600, 96, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_equals_plain(cuda, b, h, kvh, s, d, causal, dtype):
    _check_flash(cuda, b, h, kvh, s, d, causal, dtype, None)


@pytest.mark.parametrize("scale", [-0.125, 0.0])
@pytest.mark.parametrize("b,h,kvh,s,d,causal", [
    (2, 4, 2, 300, 64, True), (1, 4, 4, 1000, 96, True),
    (1, 4, 2, 512, 80, False), (2, 8, 2, 129, 128, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_any_scale(cuda, b, h, kvh, s, d, causal, dtype, scale):
    """A negative scale (the raw max would be the scaled min) and scale 0
    (every visible key weighs alike: each row is the mean of its visible V
    rows)."""
    _check_flash(cuda, b, h, kvh, s, d, causal, dtype, scale)


def _check_flash(cuda, b, h, kvh, s, d, causal, dtype, scale):
    q = _normal((b, h, s, d), 1, dtype, cuda)
    k = _normal((b, kvh, s, d), 2, dtype, cuda)
    v = _normal((b, kvh, s, d), 3, dtype, cuda)
    got = ops.attention(q, k, v, causal=causal, scale=scale, impl="cuda")
    want = ops.attention(q, k, v, causal=causal, scale=scale, impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= FLASH_TOL[dtype], err
    # and each 64-row band to its own scale (late causal rows are small)
    band = ref.band_rel_err(got, want)
    assert band <= ref.ATTENTION_BAND_TOL[dtype], band


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
    got = _check_grouped(x, te, w, bt, dtype)
    assert not got[torch.from_numpy(token_map < 0).to(cuda)].any()


def _check_grouped(x, te, w, bt, dtype):
    """The kernel against the plain version: the absolute tolerance, and
    each block_t row band to its own scale (a lost or repeated w chunk
    moves a band by a share of its magnitude; a band the plain version
    leaves zero must stay zero)."""
    got = ops.grouped_matmul(x, te, w, block_t=bt, impl="cuda")
    want = ops.grouped_matmul(x, te, w, block_t=bt, impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == (x.shape[0], w.shape[2])
    err = (got.float() - want.float()).abs().max().item()
    assert err <= GROUPED_TOL[dtype], err
    band = ref.band_rel_err(got, want, band=bt)
    assert band <= ref.GROUPED_BAND_TOL[dtype], band
    return got


@pytest.mark.parametrize("layout", ["one_tile", "long_run", "one_expert",
                                    "ids_outside"])
@pytest.mark.parametrize("bt", grouped_mm.BLOCK_TS)
@pytest.mark.parametrize("d,f", [(1024, 512), (40, 48), (24, 20)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_kernel_tile_layouts(cuda, layout, bt, d, f, dtype):
    """Layouts the decode kernel's chunking and the TMA kernel's items
    must get right: a single tile; a run of one expert longer than a
    32-row chunk; every tile on one expert (the decode tail's shape); and
    expert ids outside [0, E), whose tiles give zeros. d = 40 and F = 48
    are ragged against the 64-wide tiles and boxes (the TMA-fed kernels);
    d = 24 and F = 20 are not 16-byte rows (the element-load kernel)."""
    e = 5
    te = {"one_tile": [2],
          "long_run": [0] + [1] * 20 + [3] * 3 + [4],
          "one_expert": [4] * 12,
          "ids_outside": [-1, 0, 0, 2, 5, 7]}[layout]
    if bt == 128:
        te = te[:6]
    tiles = len(te)
    x = _normal((tiles * bt, d), 5, dtype, cuda)
    x[-bt // 2:] = 0                                  # trailing pad rows
    w = _normal((e, d, f), 6, dtype, cuda, scale=d ** -0.5)
    te_t = torch.tensor(te, dtype=torch.int32, device=cuda)
    got = _check_grouped(x, te_t, w, bt, dtype)
    dead = torch.tensor([not 0 <= i < e for i in te], device=cuda)
    assert not got.reshape(tiles, bt, f)[dead].any()
    assert not got[-bt // 2:].any()


def test_lm_wrappers_raise_before_launch(cuda):
    q = torch.zeros((1, 4, 64, 48), device=cuda)
    with pytest.raises(ValueError):       # head dim 48 is not built
        flash_attention.flash_attention(q, q, q)
    with pytest.raises(ValueError):       # ... whatever the scale
        flash_attention.flash_attention(q.bfloat16(), q.bfloat16(),
                                        q.bfloat16(), scale=0.0)
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


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m",
                                  "phi-3-vision-4.2b"])
def test_generate_on_card_equals_cpu(cuda, arch):
    """A reduced f32 model on the kernel route (flash; grouped for moe)
    gives the CPU's plain-version logits and greedy tokens; phi-3-vision
    keeps its head dim, 96, and its patch prefix."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.serve import generate, make_prefill

    cfg = reduced(get_config(arch)).replace(attn_impl="kernel",
                                            moe_dispatch="grouped")
    if cfg.family == "vlm":
        cfg = cfg.replace(head_dim=get_config(arch).head_dim)
    mod = get_model(cfg)
    cpu = mod.init(cfg, torch.Generator("cpu").manual_seed(0), device="cpu")
    card = mod.empty(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 300))}
    prefix = 0
    if cfg.family == "vlm":
        prefix = cfg.n_patches
        batch["patches"] = rng.standard_normal(
            (2, prefix, cfg.d_model)).astype(np.float32)
    ops.reset_launch_counts()
    got = generate(card, cfg, batch, 6)
    assert ops.launch_counts()["flash_attention"] > 0
    if cfg.family == "moe":
        assert ops.launch_counts()["grouped_matmul"] > 0
    want = generate(cpu, cfg, batch, 6, device="cpu")
    assert torch.equal(got.cpu(), want)
    logits = make_prefill(cfg)(card, batch,
                               mod.init_cache(cfg, 2, 301 + prefix))[0]
    ref_logits = make_prefill(cfg, device="cpu")(
        cpu, batch, mod.init_cache(cfg, 2, 301 + prefix, device="cpu"))[0]
    assert torch.allclose(logits.cpu(), ref_logits, atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b",
                                  "whisper-base"])
def test_new_families_generate_on_card_equals_cpu(cuda, arch):
    """rwkv6, zamba2 (shared block on the flash route, head dim 80) and
    whisper (plain route) at reduced size, f32: the card's greedy tokens
    and prefill logits equal the CPU's; a 512-token rwkv6 / zamba2
    prompt runs the chunked recurrence."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.serve import generate, make_prefill

    cfg = reduced(get_config(arch))
    if cfg.family == "hybrid":
        cfg = cfg.replace(head_dim=80, attn_impl="kernel")
    mod = get_model(cfg)
    cpu = mod.init(cfg, torch.Generator("cpu").manual_seed(0), device="cpu")
    card = mod.empty(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    s = 64 if cfg.family == "audio" else 512
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, s))}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    ops.reset_launch_counts()
    got = generate(card, cfg, batch, 6)
    if cfg.family == "hybrid":
        assert ops.launch_counts()["flash_attention"] == \
            cfg.n_layers // cfg.shared_attn_every
    want = generate(cpu, cfg, batch, 6, device="cpu")
    assert torch.equal(got.cpu(), want)
    logits = make_prefill(cfg)(card, batch, mod.init_cache(cfg, 2, s + 1))[0]
    ref_logits = make_prefill(cfg, device="cpu")(
        cpu, batch, mod.init_cache(cfg, 2, s + 1, device="cpu"))[0]
    assert torch.allclose(logits.cpu(), ref_logits, atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-4b", "qwen1.5-4b",
                                  "llama3.2-3b", "phi-3-vision-4.2b",
                                  "granite-moe-1b-a400m",
                                  "qwen3-moe-235b-a22b", "rwkv6-7b",
                                  "zamba2-2.7b", "whisper-base"])
def test_train_step_on_card_equals_cpu(cuda, arch):
    """Three train steps (reduced, f32, TF32 off, plain routes) on the card
    from the CPU's weights: the CPU's loss, xent, aux and grad_norm within
    rtol 1e-4, params within atol 1e-5."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.train import adamw_init, make_train_step
    from repro_torch.train.optimizer import AdamWConfig

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = reduced(get_config(arch))
    mod = get_model(cfg)
    cpu = mod.init(cfg, torch.Generator("cpu").manual_seed(0), device="cpu")
    card = mod.empty(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 64)),
             "labels": rng.integers(0, cfg.vocab, (2, 64))}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    runs = []
    for model in (cpu, card):
        step = make_train_step(cfg, AdamWConfig(lr=1e-3))
        opt = adamw_init(model, AdamWConfig(lr=1e-3))
        metrics = []
        for _ in range(3):
            model, opt, m = step(model, opt, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append(metrics)
    for got, want in zip(runs[1], runs[0]):
        for k in ("loss", "xent", "grad_norm", "lr"):
            assert got[k] == pytest.approx(want[k], rel=1e-4), k
        assert got["aux"] == pytest.approx(want["aux"], rel=1e-4, abs=1e-6)
    for (name, a), b in zip(cpu.named_parameters(), card.parameters()):
        assert torch.allclose(b.cpu(), a, atol=1e-5, rtol=0), name


def test_kernel_routes_refuse_autograd_on_card(cuda):
    q, k, v = (torch.randn((1, n, 256, 64), device=cuda, requires_grad=True)
               for n in (4, 2, 2))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.attention(q, k, v)
    x = torch.randn((16, 64), device=cuda, requires_grad=True)
    w = torch.randn((2, 64, 32), device=cuda)
    te = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.grouped_matmul(x, te, w, block_t=8)
    with torch.no_grad():           # inference launches as before
        ops.reset_launch_counts()
        ops.attention(q, k, v)
        ops.grouped_matmul(x, te, w, block_t=8)
        counts = ops.launch_counts()
    assert counts["flash_attention"] == 1 and counts["grouped_matmul"] == 1
    out = ops.attention(q, k, v, impl="torch")      # the plain route trains
    out.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


# ---------------------------------------------------------------------------
# The dense pair_scores kernel, the resident service and the supervisor on
# the card (tolerances of tests/test_kernels.py: 1e-5 f32, 2e-2 bf16)
# ---------------------------------------------------------------------------

DENSE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("m,n,d", [(64, 64, 32), (200, 130, 64),
                                   (128, 128, 256), (257, 31, 128),
                                   (1024, 1024, 256), (300, 700, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("triangular", [False, True])
@pytest.mark.parametrize("bm,bn", [(64, 64), (128, 128), (256, 256),
                                   (32, 128)])
def test_dense_kernel_equals_plain(cuda, m, n, d, dtype, triangular, bm, bn):
    rng = np.random.default_rng(m + d)
    a = rng.standard_normal((m, d)).astype(np.float32)
    b = rng.standard_normal((n, d)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    dt = getattr(torch, dtype)
    ta, tb = (torch.from_numpy(x).to(cuda, dt) for x in (a, b))
    kw = dict(threshold=0.05, triangular=triangular)
    ops.reset_launch_counts()
    got = ops.pair_scores(ta, tb, block_m=bm, block_n=bn, impl="cuda", **kw)
    assert ops.launch_counts()["pair_scores"] == 1
    want = ops.pair_scores(ta, tb, impl="torch", **kw)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and got.dtype == torch.float32
    # a cell may be kept on one side only where its score lies within the
    # tolerance of the threshold
    err = (got - want).abs()
    s = want.where(want != 0, got)
    flip = (got == 0) != (want == 0)
    assert bool(((s[flip] - 0.05).abs() <= DENSE_TOL[dtype]).all())
    assert err[~flip].max().item() <= DENSE_TOL[dtype]
    if triangular:
        assert not got.tril().any()


def test_dense_wrapper_raises(cuda):
    f = torch.zeros((64, 32), device=cuda)
    with pytest.raises(ValueError):
        pair_sim.pair_scores(f, f, block_m=16, block_n=16)
    with pytest.raises(ValueError):
        pair_sim.pair_scores(f.double(), f.double())
    with pytest.raises(ValueError):
        pair_sim.pair_scores(f, f.cpu())


# The bf16 wgmma + TMA route (csrc/dense_scores.cu): every geometry it
# serves, ragged M, N and d (d past one k16 step, past one 64-column chunk,
# below 16), M or N below one tile; held at the f32 tolerance, since bf16
# products are exact in f32 and only the order of the f32 sums differs.
TMA_GEOMETRIES = [g for g in pair_sim.GEOMETRY_LATTICE if g[0] >= 64]
TMA_SHAPES = [(64, 64, 32), (200, 132, 40), (12, 20, 8), (1024, 1024, 256),
              (300, 700, 72), (4, 1000, 136), (516, 4, 64)]


def _unit_bf16(cuda, n, d, seed):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x).to(cuda, torch.bfloat16)


def _check_dense_route(a, b, bm, bn, triangular, route, tol, thr=0.05):
    assert pair_sim.dense_route(a, b, bm, bn) == route
    kw = dict(threshold=thr, triangular=triangular)
    ops.reset_launch_counts()
    got = ops.pair_scores(a, b, block_m=bm, block_n=bn, impl="cuda", **kw)
    counts = ops.launch_counts()
    assert counts["pair_scores"] == counts[f"pair_scores[{route}]"] == 1
    want = ops.pair_scores(a, b, impl="torch", **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    s = want.where(want != 0, got)
    flip = (got == 0) != (want == 0)
    assert bool(((s[flip] - thr).abs() <= tol).all())
    assert (got - want).abs()[~flip].max().item() <= tol
    if triangular:
        assert not got.tril().any()
    return got, want


@pytest.mark.parametrize("m,n,d", TMA_SHAPES)
@pytest.mark.parametrize("triangular", [False, True])
@pytest.mark.parametrize("bm,bn", TMA_GEOMETRIES)
def test_dense_tma_route_equals_plain(cuda, m, n, d, triangular, bm, bn):
    a = _unit_bf16(cuda, m, d, m + d)
    b = a if triangular else _unit_bf16(cuda, n, d, n + 2 * d)
    _check_dense_route(a, b, bm, bn, triangular, "tma",
                       DENSE_TOL["float32"])


@pytest.mark.parametrize("bm,bn", TMA_GEOMETRIES)
@pytest.mark.parametrize("triangular", [False, True])
def test_dense_tma_route_dyadic_bit_exact(cuda, bm, bn, triangular):
    """Integers x 2^-3: every partial sum is exact in f32, so the wgmma
    route equals the plain version bit for bit, ties at the threshold
    included; d 200 ends in a ragged 64-column chunk."""
    a = torch.from_numpy(_dyadic(300, 200, 5)).to(cuda, torch.bfloat16)
    b = a if triangular else torch.from_numpy(_dyadic(260, 200, 6)).to(
        cuda, torch.bfloat16)
    got, want = _check_dense_route(a, b, bm, bn, triangular, "tma", 0.0,
                                   thr=0.5)
    assert torch.equal(got, want)
    assert bool((got == 0.5).any())        # ties at the threshold are kept


@pytest.mark.parametrize("case", ["misaligned", "d12", "n130", "bm32"])
@pytest.mark.parametrize("triangular", [False, True])
def test_dense_bf16_fma_route(cuda, case, triangular):
    """bf16 that TMA cannot address, or block_m 32, runs the FMA kernel and
    counts under its own key."""
    m, n, d, bm = 200, 132, 64, 64
    if case == "d12":
        d = 12
    elif case == "n130":
        m = n = 130
    elif case == "bm32":
        bm = 32
    a = _unit_bf16(cuda, m, d, 11)
    b = a if triangular else _unit_bf16(cuda, n, d, 12)
    if case == "misaligned":
        a = torch.cat([a.new_zeros(1), a.flatten()])[1:].view(m, d)
        if triangular:
            b = a
    _check_dense_route(a, b, bm, 128, triangular, "fma",
                       DENSE_TOL["bfloat16"])


def test_dense_tma_launch_refuses_what_tma_cannot_address(cuda):
    a = _unit_bf16(cuda, 64, 64, 1)
    out = torch.empty((64, 64), device=cuda)
    pair_sim._launch_dense("tma", a, a, out, 0.1, False, 64, 64)
    torch.cuda.synchronize()
    for args in ((a, a[:62], out[:, :62].contiguous(), 64, 64),   # n % 4
                 (a[:, :12].contiguous(), a[:, :12].contiguous(), out,
                  64, 64),                                     # d % 8
                 (a, a, out, 32, 64),                          # block_m 32
                 (torch.cat([a.new_zeros(1), a.flatten()])[1:].view(64, 64),
                  a, out, 64, 64)):                            # alignment
        x, y, o, bm, bn = args
        with pytest.raises(RuntimeError):
            pair_sim._launch_dense("tma", x, y, o, 0.1, False, bm, bn)


def _service_workload():
    ds = make_products(700, seed=2)
    corpus = list(ds.titles[:600]) + ["", "   "]
    queries = (list(ds.titles[600:680]) + ["", "@@@ never seen block 01"]
               + list(ds.titles[:5]))
    return corpus, queries


def test_service_on_card_equals_cpu(cuda):
    from repro_torch.er import ERService, ServiceConfig, compile_counter

    corpus, queries = _service_workload()
    cfg = ServiceConfig(r=8, m=4, feature_dim=128, max_len=48,
                        query_buckets=(8, 32, 64), tile_chunk=64)
    card = ERService(corpus, cfg, device="cuda")
    cpu = ERService(corpus, cfg, device="cpu")
    card.warmup()
    ops.reset_launch_counts()
    with compile_counter() as steady:
        for lo, hi in ((0, 7), (7, 40), (40, len(queries))):
            assert set(card.match(queries[lo:hi])) == set(
                cpu.match(queries[lo:hi]))
    assert steady.count == 0
    assert ops.launch_counts()["pair_scores_catalog_compact"] > 0
    assert card.stats["planned_pairs"] == cpu.stats["planned_pairs"]
    assert card.stats["bucket_hits"] == cpu.stats["bucket_hits"]


def test_supervised_run_er_on_card(cuda):
    from repro_torch.er import FaultInjector, FaultScript

    titles = list(make_products(1500, seed=3).titles)
    base = dict(r=8, m=4, feature_dim=128, max_len=48)
    want = run_er(titles, ERConfig(**base), device="cpu")
    script = FaultScript.random(0, 4, 8, straggle_delay=1e6)
    got = run_er(titles, ERConfig(supervised_devices=4, max_retries=10,
                                  shard_deadline_s=60.0, **base),
                 fault_injector=FaultInjector(script), device="cuda")
    assert got.matches == want.matches
    assert got.coverage == 1.0
    tuned = run_er(titles, ERConfig(tune_tiles=True, **base),
                   device="cuda")
    assert tuned.matches == want.matches


# ---------------------------------------------------------------------------
# The mesh on the card: 1 shard and 8 logical shards of cuda:0 against
# the same mesh of CPU shards
# ---------------------------------------------------------------------------

def _card_mesh(n_data, n_model=1):
    from repro_torch.sharding import make_er_mesh
    return make_er_mesh(n_data, n_model,
                        devices=["cuda:0"] * (n_data * n_model))


def _cpu_mesh(n_data, n_model=1):
    from repro_torch.sharding import make_er_mesh
    return make_er_mesh(n_data, n_model, devices=["cpu"] * (n_data * n_model))


@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("strategy", ["basic", "block_split", "pair_range",
                                      "sorted_neighborhood"])
def test_run_er_mesh_on_card_equals_cpu(cuda, shards, strategy):
    ds = make_products(1500, seed=3)
    titles = list(ds.titles)
    titles[::97] = ["" for _ in titles[::97]]          # key-less entities
    cfg = ERConfig(strategy=strategy, r=8, m=4, feature_dim=128, max_len=48,
                   comms="ring" if shards > 1 else "flat")
    ops.reset_launch_counts()
    got = run_er(titles, cfg, mesh=_card_mesh(shards), device="cuda")
    assert ops.launch_counts()["pair_scores_catalog_compact"] >= shards
    want = run_er(titles, cfg, mesh=_cpu_mesh(shards), device="cpu")
    assert got.matches == want.matches
    assert got.extra.get("comms_fallback") == want.extra.get("comms_fallback")


def _near_only(got, want, feats, thr):
    """Survivor sets differ only on pairs whose f64 score lies within 1e-6
    of the f32 threshold (chip_smoke.py's NEAR)."""
    t = float(np.float32(thr))
    for a, b in got ^ want:
        s = float(np.dot(feats[a].astype(np.float64),
                         feats[b].astype(np.float64)))
        assert abs(s - t) <= 1e-6, (a, b, s)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("mesh_shape,comms", [
    ((8, 1), "flat"), ((8, 1), "ring"), ((8, 1), "hierarchical"),
    ((4, 2), "flat"), ((4, 2), "hierarchical")])
def test_execute_mesh_on_card_equals_cpu(cuda, mesh_shape, comms, compact):
    from repro_torch.er.compiler import execute

    rng = np.random.default_rng(7)
    n, d = 8 * 256, 64
    cuts = np.sort(rng.choice(np.arange(1, n), 15, replace=False))
    bids = np.repeat(np.arange(16), np.diff(np.r_[0, cuts, n]))
    cat = lower(plan_to_job(plan_pair_range(
        compute_bdm(bids, np.zeros(n, np.int64), 16, 1), 8)), 64, 64)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    model_axis = "model" if mesh_shape[1] > 1 else None
    kw = dict(threshold=0.1, comms=comms, compact=compact,
              model_axis=model_axis)
    ops.reset_launch_counts()
    got = execute(cat, feats, mesh=_card_mesh(*mesh_shape), **kw)
    launched = ops.launch_counts()
    want = execute(cat, feats, mesh=_cpu_mesh(*mesh_shape), **kw)
    if model_axis is None:
        kernel = ("pair_scores_catalog_compact" if compact
                  else "pair_scores_catalog")
        assert launched[kernel] > 0
    to_set = (lambda ab: set(zip(ab[0].tolist(), ab[1].tolist())))
    assert to_set(want)
    _near_only(to_set(got), to_set(want), feats, 0.1)


def _copy_tree(dst, src):
    """Copy ``src``'s tensors (a tuple of models, nested dicts, tensors)
    into ``dst``'s, in place."""
    if isinstance(dst, torch.nn.Module):
        dst.load_state_dict(src.state_dict())
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_tree(d, s)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    elif isinstance(dst, torch.Tensor):
        dst.copy_(src)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["smollm-360m", "phi-3-vision-4.2b",
                                  "granite-moe-1b-a400m", "rwkv6-7b",
                                  "zamba2-2.7b", "whisper-base"])
def test_cell_on_card_equals_cpu(cuda, arch, kind):
    """``steps.build_cell(device="cuda")`` on the one-card test mesh runs,
    and from the CPU cell's weights, inputs and context (reduced, f32, TF32
    off, 2 trips of depth) gives the CPU cell's outputs: logits within atol
    2e-3 / rtol 1e-2, train metrics within rtol 1e-4 and params within atol
    1e-5; the specs are the CPU cell's."""
    from repro_torch.configs import Shape, get_config, reduced
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import build_cell

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = reduced(get_config(arch))
    shape = Shape(kind, 32, 2, kind)
    cpu = build_cell(cfg, shape, make_test_mesh(devices=["cpu"]), 2,
                     device="cpu")
    card = build_cell(cfg, shape, make_test_mesh(1), 2, device="cuda")
    assert card.in_specs == cpu.in_specs
    _copy_tree(card.args, cpu.args)
    got, want = card.fn(*card.args), cpu.fn(*cpu.args)
    if kind == "train":
        for k in ("loss", "xent", "grad_norm"):
            assert float(got[2][k]) == pytest.approx(float(want[2][k]),
                                                     rel=1e-4), k
        for (name, a), b in zip(want[0].named_parameters(),
                                got[0].parameters()):
            assert torch.allclose(b.cpu(), a, atol=1e-5, rtol=0), name
    else:
        assert torch.allclose(got[0].cpu(), want[0], atol=2e-3, rtol=1e-2)
        assert got[1]["pos"] == want[1]["pos"]

"""Card tests of the port: the CUDA catalog kernels against their plain
PyTorch versions, and ``run_er`` on the card against ``run_er`` on the
CPU. Marked ``gpu``; each test asks the ``cuda`` fixture for the card and
skips without one. Run them on the card with ``pytest -m gpu``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import compute_bdm, plan_pair_range, plan_sorted_neighborhood  # noqa: E402
from repro_torch.er import ERConfig, make_products, run_er  # noqa: E402
from repro_torch.er.compiler import cross_job, lower, plan_to_job  # noqa: E402
from repro_torch.kernels import build, ops, pair_sim, ref  # noqa: E402

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

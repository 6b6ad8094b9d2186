"""The dense ``pair_scores`` kernels' route rule and the bf16 TMA kernel's
shared-memory model, on the CPU: ``pair_sim.dense_route`` over dtype, d, N,
alignment and geometry; ``dense_tma_smem_bytes`` against the 227 KB a block
may use; the module imports and answers without ``nvcc``. The plain
version is held against the Pallas kernel at the route's widths in
tests/test_torch_dense_kernel.py, and the kernels against the plain
version on the card (tests/test_torch_gpu.py, chip_smoke.py phase D)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro_torch.kernels import build, ops, pair_sim  # noqa: E402
from torch_parity import unit  # noqa: E402


def _features(n, d, dtype=torch.bfloat16, offset=0):
    """(n, d) zeros whose data pointer lies ``offset`` elements past a
    64-byte aligned allocation."""
    base = torch.zeros(n * d + 64, dtype=dtype)
    skip = (-base.data_ptr() // base.element_size()) % 32 + offset
    return base[skip:skip + n * d].view(n, d)


@pytest.mark.parametrize("bm,bn", pair_sim.GEOMETRY_LATTICE)
def test_route_by_geometry(bm, bn):
    a = _features(256, 64)
    want = "tma" if bm >= 64 else "fma"
    assert pair_sim.dense_route(a, a, bm, bn) == want


@pytest.mark.parametrize("d,n,offset,want", [
    (256, 16_384, 0, "tma"),     # the DS1 case
    (8, 64, 0, "tma"),           # d one TMA-addressable step
    (40, 64, 0, "tma"),          # d past one k16 step, not a 64 multiple
    (72, 12, 0, "tma"),          # d past one chunk; N below a tile
    (7, 64, 0, "fma"),           # d % 8 != 0: the bf16 row stride
    (12, 64, 0, "fma"),
    (64, 130, 0, "fma"),         # N % 4 != 0: the f32 output's row stride
    (128, 31, 0, "fma"),
    (64, 64, 1, "fma"),          # a 2-byte offset: not 16-byte aligned
    (64, 64, 4, "fma"),          # an 8-byte offset
    (64, 64, 8, "tma"),          # 16 bytes past a 64-byte boundary: aligned
])
def test_route_by_width_rows_and_alignment(d, n, offset, want):
    a = _features(n, d, offset=offset)
    b = _features(n, d)
    assert pair_sim.dense_route(a, b, 128, 128) == want
    # the rule is symmetric in which operand is misaligned
    assert pair_sim.dense_route(b, a, 128, 128) == want


def test_f32_always_takes_the_fma_route():
    a = _features(64, 64, dtype=torch.float32)
    for bm, bn in pair_sim.GEOMETRY_LATTICE:
        assert pair_sim.dense_route(a, a, bm, bn) == "fma"


def test_tma_smem_model():
    for bm, bn in pair_sim.GEOMETRY_LATTICE:
        if bm < 64:
            continue
        need = pair_sim.dense_tma_smem_bytes(bm, bn)
        assert 0 < need <= pair_sim.SMEM_BUDGET_BYTES
        # the kernel works in sub-tiles of at most 128 x 128
        assert need == pair_sim.dense_tma_smem_bytes(min(bm, 128),
                                                     min(bn, 128))
    # 128 x 128: 1,024 alignment + 4 stages of 256 rows x 128 B + the
    # 64 KB f32 sub-tile + the 8 KB zero box + 8 barriers
    assert pair_sim.dense_tma_smem_bytes(128, 128) == \
        1024 + 4 * 256 * 128 + 128 * 128 * 4 + 8192 + 64
    assert pair_sim.dense_tma_smem_bytes(64, 32) < \
        pair_sim.dense_tma_smem_bytes(128, 128)


def test_import_builds_nothing_and_cpu_tensors_run_plain():
    """No nvcc here: the route and the model answer, the CPU call runs the
    plain version without a build or a launch, and the kernel wrapper
    refuses CPU tensors before it would build."""
    built = dict(build.BUILD_LOG)
    a = torch.from_numpy(unit(np.random.default_rng(3), 64, 64)).to(
        torch.bfloat16)
    assert pair_sim.dense_route(a, a, 128, 128) == "tma"
    ops.reset_launch_counts()
    got = ops.pair_scores(a, a, threshold=0.1, triangular=True)
    assert got.shape == (64, 64) and not got.tril().any()
    counts = ops.launch_counts()
    assert counts["pair_scores"] == counts["pair_scores[tma]"] == \
        counts["pair_scores[fma]"] == 0
    with pytest.raises(ValueError):
        pair_sim.pair_scores(a, a)
    assert build.BUILD_LOG == built

"""Tile-catalog pair similarity — stage 1 of the ER match job — as CUDA
kernels written by hand for Hopper (``csrc/pair_sim.cu``).

Port of ``repro.kernels.pair_sim``'s catalog kernels. For catalog entry t
the kernel scores ``A[a_tile·bm : +bm] · B[b_tile·bn : +bn]ᵀ`` in f32 and
keeps a cell when ``score >= threshold`` and :func:`catalog_tile_mask`
holds. Two entry points:

  * :func:`pair_scores_catalog` — (T, bm, bn) f32 0/1 survivor masks;
  * :func:`pair_scores_catalog_compact` — ``(packed, counts)``: survivors'
    tile-local ids ``i·bn + j`` in row-major order, 0 past
    ``min(count, capacity)``, and the EXACT per-tile count.

A wrapper checks its CUDA tensors and launches its kernel on the current
stream, raising if the check or the launch fails; CPU tensors raise too.
``ops.py`` chooses between these wrappers and the plain PyTorch versions
in ``ref.py``. :data:`LAUNCHES` counts kernel launches per wrapper.

The TPU kernel's VMEM budget becomes a Hopper shared-memory model:
:func:`catalog_smem_bytes` is what one block of the CUDA kernel holds and
:func:`check_smem` raises before launch when a geometry does not fit the
227 KB a block may use. The d axis streams through shared memory in
32-column chunks and survivors go straight to device memory, so neither d
nor the capacity enters the model; registers are bounded by construction
(at most 64 f32 accumulators a thread).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

__all__ = ["NCOLS", "GEOMETRY_LATTICE", "SMEM_BUDGET_BYTES",
           "catalog_smem_bytes", "check_smem", "catalog_tile_mask",
           "pair_scores_catalog", "pair_scores_catalog_compact", "LAUNCHES"]

# Catalog entry layout (int32 columns), as in repro.kernels.pair_sim.
# Rows/cols are *global* row indices of the feature matrices; a tile covers
# rows [a_tile·bm, (a_tile+1)·bm) × cols [b_tile·bn, (b_tile+1)·bn).
#   0 a_tile   LHS strip index (units of block_m)
#   1 b_tile   RHS strip index (units of block_n)
#   2 r0, 3 r1 valid row window [r0, r1)   (task bounds)
#   4 c0, 5 c1 valid col window [c0, c1)
#   6 tri      1 → keep only row < col (intra-block tasks)
#   7 lb_r, 8 lb_c   lower corner cut: keep (row > lb_r) | (col >= lb_c)
#   9 ub_r, 10 ub_c  upper corner cut: keep (row < ub_r) | (col <= ub_c)
#  11 band     > 0 → keep only col − row < band (Sorted Neighborhood)
#  12 reducer  owning reduce task (host-side attribution)
NCOLS = 13

# (block_m, block_n) geometries the CUDA kernel is instantiated for.
GEOMETRY_LATTICE = ((32, 32), (32, 64), (32, 128), (32, 256),
                    (64, 32), (64, 64), (64, 128), (64, 256),
                    (128, 32), (128, 64), (128, 128), (128, 256),
                    (256, 32), (256, 64), (256, 128), (256, 256))

# Shared memory one block may use on an H100 (232,448 B of the SM's 256 KB).
SMEM_BUDGET_BYTES = 227 * 1024

_CHUNK = 32            # d columns staged per mainloop step
_MAX_ACC = 128 * 128   # sub-tile cells: 64 accumulators per thread

# Launches of each CUDA kernel, counted where the wrapper launches it.
LAUNCHES = {"pair_scores_catalog": 0, "pair_scores_catalog_compact": 0}


def catalog_smem_bytes(block_m: int, block_n: int) -> int:
    """Dynamic shared memory of one block of the catalog kernels: two
    transposed (+1 padded) 32-column strip chunks of the sub-tile plus the
    tile's keep bits. Neither d nor the capacity enters (see above)."""
    sn = min(block_n, 128)
    sm = min(block_m, _MAX_ACC // sn)
    return 4 * (_CHUNK * ((sm + 1) + (sn + 1)) + block_m * block_n // 32)


def check_smem(block_m: int, block_n: int) -> None:
    """Raise before launch on a geometry the CUDA kernel cannot run."""
    if (block_m, block_n) not in GEOMETRY_LATTICE:
        raise ValueError(f"tile geometry ({block_m}, {block_n}) is not in "
                         f"the kernel's lattice {GEOMETRY_LATTICE}")
    need = catalog_smem_bytes(block_m, block_n)
    if need > SMEM_BUDGET_BYTES:
        raise ValueError(
            f"tile geometry ({block_m}, {block_n}) needs {need} B shared "
            f"memory per block > budget {SMEM_BUDGET_BYTES} B")


def catalog_tile_mask(entry, gi, gj):
    """The membership predicate of one catalog entry. ``entry`` holds the
    NCOLS integer columns (each broadcastable against ``gi``/``gj``, the
    global row/col index grids)."""
    keep = (gi >= entry[2]) & (gi < entry[3])
    keep = keep & (gj >= entry[4]) & (gj < entry[5])
    keep = keep & ((entry[6] == 0) | (gi < gj))
    keep = keep & ((gi > entry[7]) | (gj >= entry[8]))
    keep = keep & ((gi < entry[9]) | (gj <= entry[10]))
    return keep & ((entry[11] == 0) | (gj - gi < entry[11]))


def _lib() -> ctypes.CDLL:
    lib = build.load("pair_sim")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pair_sim_catalog_launch.argtypes = (
            [i, i, i, p, p, p] + [i] * 6 + [ctypes.c_float, p, p, p, i, p])
        lib.pair_sim_catalog_launch.restype = i
        lib.pair_sim_smem_bytes.argtypes = [i, i]
        lib.pair_sim_smem_bytes.restype = i
        lib.pair_sim_error_string.argtypes = [i]
        lib.pair_sim_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(a, b, catalog, block_m, block_n, capacity=None):
    dev = a.device
    if dev.type != "cuda" or b.device != dev or catalog.device != dev:
        raise ValueError("the CUDA kernel needs a, b and catalog on one "
                         f"CUDA device (got {a.device}, {b.device}, "
                         f"{catalog.device})")
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
        raise ValueError(f"a and b must both be float32 or bfloat16 "
                         f"(got {a.dtype}, {b.dtype})")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1] \
            or a.shape[1] < 1:
        raise ValueError(f"a (M, d) and b (N, d) with d >= 1 expected "
                         f"(got {tuple(a.shape)}, {tuple(b.shape)})")
    if catalog.dtype != torch.int32 or catalog.dim() != 2 \
            or catalog.shape[1] != NCOLS:
        raise ValueError(f"catalog must be (T, {NCOLS}) int32 (got "
                         f"{tuple(catalog.shape)} {catalog.dtype})")
    if not (a.is_contiguous() and b.is_contiguous()
            and catalog.is_contiguous()):
        raise ValueError("a, b and catalog must be contiguous")
    if max(a.numel(), b.numel()) >= 2 ** 31 - 1:
        raise ValueError("feature matrices must hold < 2**31 elements")
    if capacity is not None and not 1 <= capacity <= block_m * block_n:
        raise ValueError(f"capacity must lie in [1, {block_m * block_n}] "
                         f"(got {capacity})")
    check_smem(block_m, block_n)


def _launch(compact, a, b, catalog, threshold, block_m, block_n, *,
            mask=None, packed=None, counts=None, capacity=0):
    lib = _lib()
    ptr = (lambda x: None if x is None else x.data_ptr())
    err = lib.pair_sim_catalog_launch(
        int(compact), int(a.dtype == torch.bfloat16), a.device.index,
        a.data_ptr(), b.data_ptr(), catalog.data_ptr(),
        a.shape[0], b.shape[0], a.shape[1], catalog.shape[0],
        block_m, block_n, float(np.float32(threshold)),
        ptr(mask), ptr(packed), ptr(counts), capacity,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError("pair_sim kernel launch failed: "
                           + lib.pair_sim_error_string(err).decode())


def pair_scores_catalog(a, b, catalog, *, threshold: float = 0.8,
                        block_m: int = 128, block_n: int = 128):
    """Survivor masks for a flat catalog of (block_m, block_n) tiles.

    a: (M, d), b: (N, d) feature matrices (float32 or bfloat16, the same
    tensor for single-source plans); catalog: (T, NCOLS) int32. Returns
    (T, block_m, block_n) float32 ∈ {0, 1}: 1 where the pair belongs to the
    entry's task AND its f32 score passes ``threshold`` (compared in f32).
    """
    _check(a, b, catalog, block_m, block_n)
    t = catalog.shape[0]
    mask = torch.empty((t, block_m, block_n), dtype=torch.float32,
                       device=a.device)
    if t:
        _launch(False, a, b, catalog, threshold, block_m, block_n, mask=mask)
        LAUNCHES["pair_scores_catalog"] += 1
    return mask


def pair_scores_catalog_compact(a, b, catalog, *, threshold: float = 0.8,
                                block_m: int = 128, block_n: int = 128,
                                capacity: int = 1024):
    """:func:`pair_scores_catalog` with the survivors compacted on device.

    Returns ``(packed, counts)``:
      * packed (T, capacity) int32 — tile-local flat pair ids
        ``i·block_n + j`` of the survivors, in row-major order; slots at
        index >= min(count, capacity) are 0.
      * counts (T, 1) int32 — the EXACT survivor count per tile, even past
        ``capacity`` (the host detects overflow and falls back to the mask
        path; survivors past ``capacity`` are dropped from ``packed``).
    """
    _check(a, b, catalog, block_m, block_n, capacity)
    t = catalog.shape[0]
    packed = torch.empty((t, capacity), dtype=torch.int32, device=a.device)
    counts = torch.empty((t, 1), dtype=torch.int32, device=a.device)
    if t:
        _launch(True, a, b, catalog, threshold, block_m, block_n,
                packed=packed, counts=counts, capacity=capacity)
        LAUNCHES["pair_scores_catalog_compact"] += 1
    return packed, counts

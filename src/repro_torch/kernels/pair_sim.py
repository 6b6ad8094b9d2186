"""Pair similarity — stage 1 of the ER match job and the dense score
matrix — as CUDA kernels written by hand for Hopper (``csrc/pair_sim.cu``).

Port of ``repro.kernels.pair_sim``. For catalog entry t the catalog
kernels score ``A[a_tile·bm : +bm] · B[b_tile·bn : +bn]ᵀ`` in f32 and keep
a cell when ``score >= threshold`` and :func:`catalog_tile_mask` holds.
Three entry points:

  * :func:`pair_scores_catalog` — (T, bm, bn) f32 0/1 survivor masks;
  * :func:`pair_scores_catalog_compact` — ``(packed, counts)``: survivors'
    tile-local ids ``i·bn + j`` in row-major order, 0 past
    ``min(count, capacity)``, and the EXACT per-tile count;
  * :func:`pair_scores` — the dense (M, N) f32 score matrix, 0 below the
    threshold (and on or below the diagonal with ``triangular``).

A wrapper checks its CUDA tensors and launches its kernel on the current
stream, raising if the check or the launch fails; CPU tensors raise too.
``ops.py`` chooses between these wrappers and the plain PyTorch versions
in ``ref.py``. :data:`LAUNCHES` counts kernel launches per wrapper, and
the dense wrapper's launches per route (``pair_scores[tma]``,
``pair_scores[fma]``).

The dense scores take one of two routes, chosen by :func:`dense_route`
from the dtype, d, N, the alignment and the geometry (never by trying one
and falling back): ``"tma"``, bf16 on the tensor cores
(``csrc/dense_scores.cu``: wgmma fed by TMA, a persistent grid, a
TMA-store epilogue), or ``"fma"``, the f32 FMA kernel on the CUDA cores
(``csrc/pair_sim.cu``'s ``dense_kernel``, for f32 and for the bf16 calls
the first cannot take).

The TPU kernel's VMEM budget becomes a Hopper shared-memory model:
:func:`catalog_smem_bytes` is what one block of the CUDA kernel holds and
:func:`check_smem` raises before launch when a geometry does not fit the
227 KB a block may use. The d axis streams through a two-stage ring of
32-column chunks in shared memory and survivors go straight to device
memory, so neither d nor the capacity enters the model; registers are
bounded by construction (at most 64 f32 accumulators a thread).
:func:`dense_tma_smem_bytes` models the bf16 TMA dense kernel (a 4-stage
ring of 64-column chunks plus the staged f32 sub-tile; 205,888 B at its
largest sub-tile, 128 × 128).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

__all__ = ["NCOLS", "GEOMETRY_LATTICE", "SMEM_BUDGET_BYTES", "DENSE_ROUTES",
           "catalog_smem_bytes", "dense_smem_bytes", "dense_tma_smem_bytes",
           "check_smem", "catalog_tile_mask", "dense_route",
           "pair_scores_catalog", "pair_scores_catalog_compact",
           "pair_scores", "LAUNCHES"]

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
_STAGES = 2            # shared stages of the staging ring
_MAX_ACC = 128 * 128   # sub-tile cells: 64 accumulators per thread

# The dense kernel's routes (see dense_route).
DENSE_ROUTES = ("tma", "fma")

# The bf16 wgmma + TMA dense kernel: d columns a k chunk, ring stages,
# bytes of one staged 64-row x 32-column f32 output box.
_TMA_CHUNK = 64
_TMA_STAGES = 4
_OUT_BOX = 64 * 32 * 4

# Launches of each CUDA kernel, counted where the wrapper launches it;
# pair_scores also per route.
LAUNCHES = {"pair_scores_catalog": 0, "pair_scores_catalog_compact": 0,
            "pair_scores": 0,
            **{f"pair_scores[{r}]": 0 for r in DENSE_ROUTES}}


def dense_smem_bytes(block_m: int, block_n: int) -> int:
    """Dynamic shared memory of one block of the dense kernel: two stages
    of the sub-tile's transposed 32-column strip chunks (its scores go
    straight to device memory)."""
    sn = min(block_n, 128)
    sm = min(block_m, _MAX_ACC // sn)
    return 4 * _STAGES * _CHUNK * (sm + sn)


def dense_tma_smem_bytes(block_m: int, block_n: int) -> int:
    """Dynamic shared memory of one block of the bf16 wgmma + TMA dense
    kernel (block_m >= 64), which works in sub-tiles of sm = min(block_m,
    128) rows by sn = min(block_n, 128) columns: the 1,024-byte alignment
    slack, a ring of 4 stages of (sm + sn) rows x 64 bf16 columns, the f32
    sub-tile staged for the TMA store, one zeroed output box and the
    stages' full and empty barriers."""
    sm, sn = min(block_m, 128), min(block_n, 128)
    return (1024 + _TMA_STAGES * (sm + sn) * _TMA_CHUNK * 2 + sm * sn * 4
            + _OUT_BOX + 8 * 2 * _TMA_STAGES)


def dense_route(a, b, block_m: int, block_n: int) -> str:
    """The dense kernel that serves ``pair_scores(a, b)`` at (block_m,
    block_n): ``"tma"`` (``csrc/dense_scores.cu``) for bf16 a and b that
    TMA can address — 16-byte aligned, d % 8 == 0 (the bf16 row stride)
    and N % 4 == 0 (the f32 output's row stride) — at block_m >= 64
    (wgmma's 64-row warpgroups), each geometry at its own tile; ``"fma"``
    (``csrc/pair_sim.cu``'s ``dense_kernel``) for everything else: f32
    (an exact f32 dot: TF32 would drop mantissa bits), bf16 that TMA cannot
    address, and block_m 32. Reads only dtypes, shapes and addresses, so it
    answers for CPU tensors too."""
    if (a.dtype == torch.bfloat16 and block_m >= 64
            and a.shape[1] % 8 == 0 and b.shape[0] % 4 == 0
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0):
        return "tma"
    return "fma"


def catalog_smem_bytes(block_m: int, block_n: int) -> int:
    """Dynamic shared memory of one block of the catalog kernels: the dense
    kernel's staged chunks plus the tile's keep bits. Neither d nor the
    capacity enters (see above)."""
    return dense_smem_bytes(block_m, block_n) + 4 * (block_m * block_n // 32)


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
        lib.pair_sim_dense_launch.argtypes = (
            [i, i, p, p] + [i] * 5 + [ctypes.c_float, i, p, p])
        lib.pair_sim_dense_launch.restype = i
        lib.pair_sim_smem_bytes.argtypes = [i, i]
        lib.pair_sim_smem_bytes.restype = i
        lib.pair_sim_error_string.argtypes = [i]
        lib.pair_sim_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _dense_lib() -> ctypes.CDLL:
    lib = build.load("dense_scores")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dense_scores_launch.argtypes = (
            [i, p, p] + [i] * 5 + [ctypes.c_float, i, p, p])
        lib.dense_scores_launch.restype = i
        lib.dense_scores_smem_bytes.argtypes = [i, i]
        lib.dense_scores_smem_bytes.restype = i
        lib.dense_scores_error_string.argtypes = [i]
        lib.dense_scores_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_features(a, b):
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("the CUDA kernel needs a and b on one CUDA device "
                         f"(got {a.device}, {b.device})")
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
        raise ValueError(f"a and b must both be float32 or bfloat16 "
                         f"(got {a.dtype}, {b.dtype})")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1] \
            or a.shape[1] < 1:
        raise ValueError(f"a (M, d) and b (N, d) with d >= 1 expected "
                         f"(got {tuple(a.shape)}, {tuple(b.shape)})")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if max(a.numel(), b.numel()) >= 2 ** 31 - 1:
        raise ValueError("feature matrices must hold < 2**31 elements")


def _check(a, b, catalog, block_m, block_n, capacity=None):
    _check_features(a, b)
    if catalog.device != a.device:
        raise ValueError(f"the catalog must lie on {a.device} (got "
                         f"{catalog.device})")
    if catalog.dtype != torch.int32 or catalog.dim() != 2 \
            or catalog.shape[1] != NCOLS:
        raise ValueError(f"catalog must be (T, {NCOLS}) int32 (got "
                         f"{tuple(catalog.shape)} {catalog.dtype})")
    if not catalog.is_contiguous():
        raise ValueError("the catalog must be contiguous")
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


def _launch_dense(route, a, b, out, threshold, triangular, block_m,
                  block_n):
    """Launches the dense kernel of ``route`` into ``out``; raises if the
    launch fails. Counts nothing (the wrapper does)."""
    m, n, d = a.shape[0], b.shape[0], a.shape[1]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    thr = float(np.float32(threshold))
    if route == "tma":
        lib = _dense_lib()
        err = lib.dense_scores_launch(
            a.device.index, a.data_ptr(), b.data_ptr(), m, n, d, block_m,
            block_n, thr, int(bool(triangular)), out.data_ptr(), stream)
        what = lib.dense_scores_error_string
    else:
        lib = _lib()
        err = lib.pair_sim_dense_launch(
            int(a.dtype == torch.bfloat16), a.device.index, a.data_ptr(),
            b.data_ptr(), m, n, d, block_m, block_n, thr,
            int(bool(triangular)), out.data_ptr(), stream)
        what = lib.pair_sim_error_string
    if err:
        raise RuntimeError(f"pair_sim dense kernel ({route}) launch failed: "
                           + what(err).decode())


def pair_scores(a, b, *, threshold: float = 0.8, triangular: bool = False,
                block_m: int = 128, block_n: int = 128):
    """Thresholded scores of every (row of a) × (row of b).

    a: (M, d), b: (N, d) float32 or bfloat16 on one CUDA device. Returns
    (M, N) float32: the f32 dot where it is >= ``threshold`` (compared in
    f32) and, with ``triangular``, row < col; 0 elsewhere. Ragged M, N and
    d are masked in the kernel, so nothing is padded or copied.

    :func:`dense_route` picks the kernel: bf16 that TMA can address at
    block_m >= 64 runs on the tensor cores (``csrc/dense_scores.cu``:
    wgmma fed by TMA, a persistent grid over the (block_m, block_n) tiles,
    a TMA-store epilogue; bf16 products are exact in f32, so only the order
    of the f32 sums differs from the plain version); everything else runs
    the f32 FMA kernel (``csrc/pair_sim.cu``), one block per tile. Either
    way a tile wholly on or below the diagonal, with ``triangular``, only
    stores zeros.
    """
    _check_features(a, b)
    if (block_m, block_n) not in GEOMETRY_LATTICE:
        raise ValueError(f"tile geometry ({block_m}, {block_n}) is not in "
                         f"the kernel's lattice {GEOMETRY_LATTICE}")
    m, n = a.shape[0], b.shape[0]
    route = dense_route(a, b, block_m, block_n)
    if route == "fma" and -(-m // block_m) > 65_535:
        raise ValueError(f"M = {m} needs more than 65,535 row tiles of "
                         f"{block_m}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m and n:
        _launch_dense(route, a, b, out, threshold, triangular, block_m,
                      block_n)
        LAUNCHES["pair_scores"] += 1
        LAUNCHES[f"pair_scores[{route}]"] += 1
    return out

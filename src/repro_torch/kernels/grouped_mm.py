"""Grouped matrix product of the MoE expert FFN as a CUDA kernel written
by hand for Hopper (``csrc/grouped_mm.cu``).

Port of ``repro.kernels.grouped_mm``. Tokens arrive sorted by expert, each
expert's segment padded to a multiple of ``block_t`` rows, and
``tile_expert[i]`` names the expert of row tile i. The kernel computes
``out = x · w[tile_expert[row // block_t]]`` with f32 accumulation and
writes ``out`` in x's dtype: the MegaBlocks-style block-diagonal product,
without the (T, E, d) one-hot dispatch.

:func:`grouped_matmul` checks its CUDA tensors and launches the kernel on
the current stream, raising if the check or the launch fails; CPU tensors
raise too. ``ops.py`` chooses between it and the plain PyTorch version in
``ref.py``. :data:`LAUNCHES` counts launches; :data:`BLOCK_T_LAUNCHES`
splits them by ``block_t``. :func:`pad_groups` is the host-side layout
helper of the reference, copied.

Which kernel of the library runs (the source note says why): bf16 rows
TMA can address (d and F multiples of 8, x and w 16-byte aligned) take
the wgmma + TMA kernel at
block_t 128 and the TMA-fed decode kernel at 8; other bf16 calls an
element-load kernel; f32 the CUDA-core kernel. :func:`smem_bytes` models
the TMA-fed kernels' shared memory.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

__all__ = ["BLOCK_TS", "KERNELS", "LAUNCHES", "BLOCK_T_LAUNCHES",
           "check_layout", "smem_bytes", "grouped_matmul",
           "pad_groups"]

# Row-tile heights the kernel is instantiated for: 128 on prefill, 8 on
# small-batch decode (the two that repro/models/moe.py picks).
BLOCK_TS = (8, 128)

# The TMA-fed bf16 kernels, in the order of the library's
# grouped_mm_smem_bytes.
KERNELS = ("tma", "decode", "decode_wide")

# Launches of the CUDA kernel, counted where the wrapper launches it.
LAUNCHES = {"grouped_matmul": 0}
BLOCK_T_LAUNCHES = {bt: 0 for bt in BLOCK_TS}


def _lib() -> ctypes.CDLL:
    lib = build.load("grouped_mm")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grouped_mm_launch.argtypes = [i, i, p, p, p, p] + [i] * 5 + [p]
        lib.grouped_mm_launch.restype = i
        lib.grouped_mm_smem_bytes.argtypes = [i]
        lib.grouped_mm_smem_bytes.restype = i
        lib.grouped_mm_error_string.argtypes = [i]
        lib.grouped_mm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def smem_bytes(kernel: str) -> int:
    """Dynamic shared memory of one block of a TMA-fed bf16 kernel
    (:data:`KERNELS`). ``tma`` (block_t 128): 1,024 bytes of alignment
    slack, a 5-stage ring of one 128 × 64 x box and two 64 × 64 w boxes,
    each consumer's 64 × 128 bf16 output tile staged for the TMA store,
    a full and an empty 8-byte mbarrier per stage. ``decode`` /
    ``decode_wide`` (block_t 8): the slack, a 3-stage ring of two / four
    64 × 64 w boxes and the chunk's 32 x rows (64 columns padded to 72,
    rounded up to 1 KB), a full mbarrier per stage."""
    if kernel == "tma":
        return (1024 + 5 * (128 * 64 * 2 + 2 * 64 * 64 * 2)
                + 2 * 64 * 128 * 2 + 8 * 2 * 5)
    boxes = {"decode": 2, "decode_wide": 4}[kernel]
    x_bytes = -(-32 * 72 * 2 // 1024) * 1024
    return 1024 + 3 * (boxes * 64 * 128 + x_bytes) + 8 * 3


def check_layout(x, tile_expert, w, block_t: int) -> None:
    """The op's contract on shapes and dtypes, whatever runs it: x (T, d)
    with T % block_t == 0, tile_expert (T // block_t,) int32, w (E, d, F)
    of x's dtype."""
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"x (T, d) and w (E, d, F) expected (got "
                         f"{tuple(x.shape)}, {tuple(w.shape)})")
    if x.shape[0] % block_t:
        raise ValueError(f"T = {x.shape[0]} is not a multiple of block_t = "
                         f"{block_t}: pad the token count to a tile "
                         "multiple (pad_groups)")
    if tile_expert.dtype != torch.int32 or tuple(tile_expert.shape) != (
            x.shape[0] // block_t,):
        raise ValueError(f"tile_expert must be ({x.shape[0] // block_t},) "
                         f"int32 (got {tuple(tile_expert.shape)} "
                         f"{tile_expert.dtype})")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError(f"x and w must both be float32 or bfloat16 (got "
                         f"{x.dtype}, {w.dtype})")


def _check(x, tile_expert, w, block_t):
    check_layout(x, tile_expert, w, block_t)
    dev = x.device
    if dev.type != "cuda" or tile_expert.device != dev or w.device != dev:
        raise ValueError("the CUDA kernel needs x, tile_expert and w on one "
                         f"CUDA device (got {x.device}, {tile_expert.device},"
                         f" {w.device})")
    if block_t not in BLOCK_TS:
        raise ValueError(f"block_t {block_t} is not one the kernel is "
                         f"built for {BLOCK_TS}")
    if not (x.is_contiguous() and tile_expert.is_contiguous()
            and w.is_contiguous()):
        raise ValueError("x, tile_expert and w must be contiguous")
    if max(x.shape[0], x.shape[1], w.shape[2]) >= 2 ** 31:
        raise ValueError("dimensions must be < 2**31")


def grouped_matmul(x, tile_expert, w, *, block_t: int = 128):
    """x (T, d) expert-sorted, tile-aligned rows (all rows of tile i belong
    to expert ``tile_expert[i]``); tile_expert (T // block_t,) int32;
    w (E, d, F). Returns (T, F) in x's dtype: ``x @ w[expert of row]``,
    accumulated in f32. Zero rows give zero rows; a tile whose expert id
    lies outside [0, E) gives zeros."""
    _check(x, tile_expert, w, block_t)
    t, d = x.shape
    e, _, f = w.shape
    out = torch.empty((t, f), dtype=x.dtype, device=x.device)
    if t and f:
        lib = _lib()
        err = lib.grouped_mm_launch(
            int(x.dtype == torch.bfloat16), x.device.index, x.data_ptr(),
            tile_expert.data_ptr(), w.data_ptr(), out.data_ptr(),
            t // block_t, block_t, d, f, e,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError("grouped_mm kernel launch failed: "
                               + lib.grouped_mm_error_string(err).decode())
        LAUNCHES["grouped_matmul"] += 1
        BLOCK_T_LAUNCHES[block_t] += 1
    return out


def pad_groups(x, group_sizes, block_t: int = 128):
    """Expert-sorted tokens + group sizes → tile-aligned layout.

    x: (T, d) tensor sorted by expert; group_sizes: (E,) with sum T.
    Returns (x_padded (Tp, d), tile_expert (Tp // block_t,) int32,
    token_map (Tp,) int64 numpy giving the source row of each padded row,
    −1 for padding). Host numpy, as in the reference (shapes depend on
    values)."""
    sizes = np.asarray(group_sizes, np.int64)
    e = sizes.shape[0]
    padded = np.maximum(-(-sizes // block_t) * block_t, 0)
    tp = int(padded.sum()) if padded.sum() else block_t
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    pstarts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    token_map = np.full(tp, -1, np.int64)
    tile_expert = np.zeros(tp // block_t, np.int32)
    for k in range(e):
        token_map[pstarts[k]: pstarts[k] + sizes[k]] = np.arange(
            starts[k], starts[k] + sizes[k])
        tile_expert[pstarts[k] // block_t:
                    (pstarts[k] + padded[k]) // block_t] = k
    src = torch.from_numpy(np.maximum(token_map, 0)).to(x.device)
    keep = torch.from_numpy(token_map >= 0).to(x.device, x.dtype)
    gathered = keep[:, None] * x[src]
    return (gathered, torch.from_numpy(tile_expert).to(x.device),
            token_map)

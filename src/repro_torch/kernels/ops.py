"""Dispatcher over the CUDA kernels and their plain versions.

Every op takes ``impl``:
  * "auto"  — the CUDA kernel for CUDA tensors, the plain PyTorch version
              for CPU tensors;
  * "cuda"  — the CUDA kernel; raises on CPU tensors;
  * "torch" — the plain PyTorch version on whatever device the tensors
              are (on the card only when asked for, as the tests and
              ``chip_smoke.py``'s comparisons do).

Port of ``repro.kernels.ops._resolve`` and ``execute._resolve_impl``.
Nothing here falls back: a failed build or launch raises.
"""
from __future__ import annotations

import torch

from . import flash_attention, grouped_mm, pair_sim, ref

__all__ = ["IMPLS", "resolve_impl", "pair_scores_catalog",
           "pair_scores_catalog_compact", "grouped_matmul", "attention",
           "launch_counts", "reset_launch_counts"]

IMPLS = ("auto", "cuda", "torch")


def resolve_impl(impl: str, device) -> str:
    """``impl`` for tensors on ``device``, resolved to "cuda" or "torch"."""
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; expected one of "
                         f"{IMPLS}")
    on_cuda = torch.device(device).type == "cuda"
    if impl == "auto":
        return "cuda" if on_cuda else "torch"
    if impl == "cuda" and not on_cuda:
        raise ValueError("kernel_impl='cuda' needs CUDA tensors; CPU "
                         "tensors run the plain version (impl='auto' or "
                         "'torch')")
    return impl


def pair_scores_catalog(a, b, catalog, *, threshold: float = 0.8,
                        block_m: int = 128, block_n: int = 128,
                        impl: str = "auto"):
    """Tile-catalog survivor masks (see ``pair_sim.pair_scores_catalog``)."""
    if resolve_impl(impl, a.device) == "torch":
        return ref.pair_scores_catalog_ref(a, b, catalog, threshold=threshold,
                                           block_m=block_m, block_n=block_n)
    return pair_sim.pair_scores_catalog(a, b, catalog, threshold=threshold,
                                        block_m=block_m, block_n=block_n)


def pair_scores_catalog_compact(a, b, catalog, *, threshold: float = 0.8,
                                block_m: int = 128, block_n: int = 128,
                                capacity: int = 1024, impl: str = "auto"):
    """Tile-catalog survivors packed on device (see
    ``pair_sim.pair_scores_catalog_compact``)."""
    if resolve_impl(impl, a.device) == "torch":
        return ref.pair_scores_catalog_compact_ref(
            a, b, catalog, threshold=threshold, block_m=block_m,
            block_n=block_n, capacity=capacity)
    return pair_sim.pair_scores_catalog_compact(
        a, b, catalog, threshold=threshold, block_m=block_m,
        block_n=block_n, capacity=capacity)


def grouped_matmul(x, tile_expert, w, *, block_t: int = 128,
                   impl: str = "auto"):
    """MoE expert product over tile-aligned expert-sorted rows (see
    ``grouped_mm.grouped_matmul``). The layout contract holds for both
    routes."""
    if resolve_impl(impl, x.device) == "torch":
        grouped_mm.check_layout(x, tile_expert, w, block_t)
        return ref.grouped_matmul_ref(x, tile_expert, w, block_t=block_t)
    return grouped_mm.grouped_matmul(x, tile_expert, w, block_t=block_t)


def attention(q, k, v, *, causal: bool = True, scale=None,
              block_q: int = 512, block_k: int = 512, impl: str = "auto"):
    """Softmax attention, q (B, H, S, D) over k, v (B, KVH, S, D), query
    head h on KV head h // (H / KVH) (see
    ``flash_attention.flash_attention``). The reference kernel's
    non-causal contract holds for both routes."""
    if resolve_impl(impl, q.device) == "torch":
        flash_attention.check_contract(q, k, v, causal=causal,
                                       block_q=block_q, block_k=block_k)
        return ref.attention_ref(q, k, v, causal=causal, scale=scale)
    return flash_attention.flash_attention(q, k, v, causal=causal,
                                           scale=scale, block_q=block_q,
                                           block_k=block_k)


_COUNTERS = (pair_sim.LAUNCHES, flash_attention.LAUNCHES,
             grouped_mm.LAUNCHES, grouped_mm.BLOCK_T_LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches per CUDA kernel since the last reset, plus the
    grouped kernel's launches per block_t (``grouped_matmul[block_t=8]``
    and ``[block_t=128]``)."""
    counts = {**pair_sim.LAUNCHES, **flash_attention.LAUNCHES,
              **grouped_mm.LAUNCHES}
    for bt, n in grouped_mm.BLOCK_T_LAUNCHES.items():
        counts[f"grouped_matmul[block_t={bt}]"] = n
    return counts


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for k in counter:
            counter[k] = 0

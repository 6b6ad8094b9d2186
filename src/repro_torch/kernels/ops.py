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

The CUDA kernels have no backward (nor have the reference's Pallas
kernels): their wrappers write into fresh outputs, so under autograd the
result would be a constant and the gradient cut. ``attention`` and
``grouped_matmul`` on the CUDA route raise when grad is enabled and an
input requires grad; their plain versions stay differentiable.
"""
from __future__ import annotations

import torch

from . import edit_distance, flash_attention, grouped_mm, ngram, pair_sim, ref

__all__ = ["IMPLS", "resolve_impl", "pair_scores", "pair_scores_catalog",
           "pair_scores_catalog_compact", "pair_scores_catalog_raw",
           "grouped_matmul", "attention", "refuse_autograd",
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


def refuse_autograd(name: str, impl: str, *tensors) -> None:
    """Raise if ``impl`` names the CUDA route (``"cuda"``, or ``"auto"`` on
    CUDA tensors) while autograd would record ``tensors``: the kernel has
    no backward."""
    on_kernel = impl == "cuda" or (
        impl == "auto" and tensors[0].device.type == "cuda")
    if on_kernel and torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; "
                           "differentiate the plain route (impl='torch', "
                           "attn_impl='plain', moe_dispatch='gshard') or "
                           "run under torch.no_grad()")


def pair_scores(a, b, *, threshold: float = 0.8, triangular: bool = False,
                block_m: int = 128, block_n: int = 128, impl: str = "auto"):
    """Dense thresholded (M, N) scores (see ``pair_sim.pair_scores``). The
    plain version ignores the tile geometry, as the JAX package's "xla"
    route does."""
    if resolve_impl(impl, a.device) == "torch":
        return ref.pair_scores_ref(a, b, threshold=threshold,
                                   triangular=triangular)
    return pair_sim.pair_scores(a, b, threshold=threshold,
                                triangular=triangular, block_m=block_m,
                                block_n=block_n)


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


def pair_scores_catalog_raw(a, b, catalog, *, block_m: int = 128,
                            block_n: int = 128, impl: str = "auto"):
    """UNthresholded, UNmasked (T, bm, bn) f32 tile scores (see
    ``ref.pair_scores_catalog_raw_ref``): the model axis's partial scores,
    whose threshold and catalog predicates only apply after the psum.
    Every ``impl`` runs the plain version (one batched f32 matmul, TF32
    off), as the JAX package routes every impl to XLA; ``impl`` is still
    checked against the tensors' device."""
    resolve_impl(impl, a.device)
    return ref.pair_scores_catalog_raw_ref(a, b, catalog, block_m=block_m,
                                           block_n=block_n)


def grouped_matmul(x, tile_expert, w, *, block_t: int = 128,
                   impl: str = "auto"):
    """MoE expert product over tile-aligned expert-sorted rows (see
    ``grouped_mm.grouped_matmul``). The layout contract holds for both
    routes. The CUDA route refuses autograd (:func:`refuse_autograd`)."""
    refuse_autograd("grouped_matmul", impl, x, w)
    if resolve_impl(impl, x.device) == "torch":
        grouped_mm.check_layout(x, tile_expert, w, block_t)
        return ref.grouped_matmul_ref(x, tile_expert, w, block_t=block_t)
    return grouped_mm.grouped_matmul(x, tile_expert, w, block_t=block_t)


def attention(q, k, v, *, causal: bool = True, scale=None,
              block_q: int = 512, block_k: int = 512, impl: str = "auto"):
    """Softmax attention, q (B, H, S, D) over k, v (B, KVH, S, D), query
    head h on KV head h // (H / KVH) (see
    ``flash_attention.flash_attention``). The reference kernel's
    non-causal contract holds for both routes. The CUDA route refuses
    autograd (:func:`refuse_autograd`)."""
    refuse_autograd("attention", impl, q, k, v)
    if resolve_impl(impl, q.device) == "torch":
        flash_attention.check_contract(q, k, v, causal=causal,
                                       block_q=block_q, block_k=block_k)
        return ref.attention_ref(q, k, v, causal=causal, scale=scale)
    return flash_attention.flash_attention(q, k, v, causal=causal,
                                           scale=scale, block_q=block_q,
                                           block_k=block_k)


_COUNTERS = (pair_sim.LAUNCHES, flash_attention.LAUNCHES,
             grouped_mm.LAUNCHES, grouped_mm.BLOCK_T_LAUNCHES,
             edit_distance.LAUNCHES, ngram.LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches per CUDA kernel since the last reset, plus the
    grouped kernel's launches per block_t (``grouped_matmul[block_t=8]``
    and ``[block_t=128]``)."""
    counts = {**pair_sim.LAUNCHES, **flash_attention.LAUNCHES,
              **grouped_mm.LAUNCHES, **edit_distance.LAUNCHES,
              **ngram.LAUNCHES}
    for bt, n in grouped_mm.BLOCK_T_LAUNCHES.items():
        counts[f"grouped_matmul[block_t={bt}]"] = n
    return counts


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for k in counter:
            counter[k] = 0

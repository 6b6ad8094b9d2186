"""Dispatcher over the catalog kernels and their plain versions.

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

from . import pair_sim, ref

__all__ = ["IMPLS", "resolve_impl", "pair_scores_catalog",
           "pair_scores_catalog_compact", "launch_counts",
           "reset_launch_counts"]

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


def launch_counts() -> dict:
    """Kernel launches per CUDA kernel since the last reset."""
    return dict(pair_sim.LAUNCHES)


def reset_launch_counts() -> None:
    for k in pair_sim.LAUNCHES:
        pair_sim.LAUNCHES[k] = 0

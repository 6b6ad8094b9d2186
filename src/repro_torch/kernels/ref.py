"""Plain PyTorch versions of the CUDA kernels: the CPU path of the
dispatcher in ``ops.py``, the oracle of the CPU tests, and what
``chip_smoke.py`` holds each CUDA kernel against on the card.

Ports of ``repro.kernels.ref``'s ``pair_scores_catalog_ref``,
``pack_survivor_mask`` and ``pair_scores_catalog_compact_ref`` (a gather of
the strips, an f32 ``einsum`` with TF32 off, the catalog predicate, and a
cumsum-plus-scatter pack with a dump slot; the threshold is compared in
f32, as the kernel and the JAX package do), of ``grouped_matmul_ref`` and
of ``attention_ref``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["pair_scores_catalog_ref", "pack_survivor_mask",
           "pair_scores_catalog_compact_ref", "grouped_matmul_ref",
           "attention_ref", "full_precision"]


@contextlib.contextmanager
def full_precision():
    """f32 matrix products in full f32 on the card (TF32 off) for the
    duration of the block; the previous setting is restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _strips(x, tiles, block: int):
    """(T, block, d) f32 strips ``x[tile·block : +block]``; rows past the
    end of ``x`` read as 0 (the JAX reference zero-pads the matrix)."""
    rows = tiles[:, None] * block + torch.arange(block, device=x.device)
    valid = rows < x.shape[0]
    s = x[torch.where(valid, rows, 0)].to(torch.float32)
    return s * valid[..., None], rows


def pair_scores_catalog_ref(a, b, catalog, *, threshold: float = 0.8,
                            block_m: int = 128, block_n: int = 128):
    """Same (T, bm, bn) f32 0/1 output as ``pair_sim.pair_scores_catalog``."""
    from .pair_sim import NCOLS, catalog_tile_mask

    cat = catalog.to(torch.int64)
    sa, gi = _strips(a, cat[:, 0], block_m)
    sb, gj = _strips(b, cat[:, 1], block_n)
    with full_precision():
        s = torch.einsum("tmd,tnd->tmn", sa, sb)
    entry = [cat[:, c, None, None] for c in range(NCOLS)]
    keep = (s >= float(np.float32(threshold))) & catalog_tile_mask(
        entry, gi[:, :, None], gj[:, None, :])
    return keep.to(torch.float32)


def pack_survivor_mask(masks, capacity: int):
    """Dense (T, bm, bn) survivor masks → the ``(packed, counts)``
    contract: an inclusive row-major cumsum gives each survivor its slot
    (rank − 1), and a scatter with a dump slot at ``capacity`` absorbs the
    dead cells and the survivors past capacity. Slots beyond
    min(count, capacity) stay 0; counts stay exact."""
    t = masks.shape[0]
    p = masks.shape[1] * masks.shape[2]
    flat = masks.reshape(t, p) > 0
    cum = torch.cumsum(flat.to(torch.int32), dim=1, dtype=torch.int32)
    counts = cum[:, -1:].contiguous()
    dest = torch.where(flat, torch.clamp(cum - 1, max=capacity), capacity)
    pos = torch.arange(p, dtype=torch.int32, device=masks.device)
    src = torch.where(flat, pos.expand(t, p), 0)
    packed = torch.zeros((t, capacity + 1), dtype=torch.int32,
                         device=masks.device)
    packed.scatter_(1, dest.to(torch.int64), src)
    return packed[:, :capacity].contiguous(), counts


def pair_scores_catalog_compact_ref(a, b, catalog, *, threshold: float = 0.8,
                                    block_m: int = 128, block_n: int = 128,
                                    capacity: int = 1024):
    """Same ``(packed, counts)`` contract as
    ``pair_sim.pair_scores_catalog_compact``: the mask of
    :func:`pair_scores_catalog_ref` packed by :func:`pack_survivor_mask`."""
    masks = pair_scores_catalog_ref(a, b, catalog, threshold=threshold,
                                    block_m=block_m, block_n=block_n)
    return pack_survivor_mask(masks, capacity)


def grouped_matmul_ref(x, tile_expert, w, *, block_t: int = 128):
    """x (T, d) tile-aligned expert-sorted rows; w (E, d, F). Same (T, F)
    as ``grouped_mm.grouped_matmul``: each row tile times its expert's
    weights, accumulated in f32 (TF32 off), cast to x's dtype. The JAX
    reference gathers w per token; this gathers it per tile, which is the
    same function in 1/block_t of the memory."""
    t, d = x.shape
    xt = x.reshape(t // block_t, block_t, d).to(torch.float32)
    with full_precision():
        out = torch.bmm(xt, w[tile_expert.long()].to(torch.float32))
    return out.reshape(t, w.shape[2]).to(x.dtype)


def attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """q (B, H, S, D); k, v (B, KVH, S, D). Plain softmax attention, h-major:
    query head h reads KV head h // (H / KVH), as ``repeat`` gives it. f32
    logits (TF32 off), softmax and p·v in f32, output in q's dtype."""
    h, s, d = q.shape[1], q.shape[2], q.shape[3]
    group = h // k.shape[1]
    if scale is None:
        scale = d ** -0.5
    k = k.repeat_interleave(group, dim=1).to(torch.float32)
    v = v.repeat_interleave(group, dim=1).to(torch.float32)
    with full_precision():
        logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                              k) * scale
        if causal:
            mask = torch.ones((s, s), dtype=torch.bool,
                              device=q.device).tril()
            logits = torch.where(mask, logits, -1e30)
        p = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)

"""Plain PyTorch versions of the CUDA kernels: the CPU path of the
dispatcher in ``ops.py``, the oracle of the CPU tests, and what
``chip_smoke.py`` holds each CUDA kernel against on the card.

Ports of ``repro.kernels.ref``'s ``pair_scores_ref`` (one f32 ``einsum``
with TF32 off, the threshold and the optional strict upper triangle),
``pair_scores_catalog_ref``,
``pack_survivor_mask`` and ``pair_scores_catalog_compact_ref`` (a gather of
the strips, an f32 ``einsum`` with TF32 off, the catalog predicate, and a
cumsum-plus-scatter pack with a dump slot; the threshold is compared in
f32, as the kernel and the JAX package do), of ``grouped_matmul_ref`` and
of ``attention_ref``. :func:`band_rel_err` is how the attention kernel is
held to ``attention_ref`` beside the absolute tolerance.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["pair_scores_ref", "pair_scores_catalog_ref", "pack_survivor_mask",
           "pair_scores_catalog_compact_ref", "grouped_matmul_ref",
           "attention_ref", "band_rel_err", "ATTENTION_BAND_TOL",
           "GROUPED_BAND_TOL",
           "full_precision"]

# The bound on band_rel_err(attention kernel, attention_ref): bf16, two
# bf16 epsilons (the output's rounding on either side, and p's rounding to
# bf16 before p·v); f32, 2**-12, far above f32 rounding over S terms and
# far below the tenths that a kv-tile fault moves a band by.
ATTENTION_BAND_TOL = {"float32": 2.0 ** -12, "bfloat16": 2.0 ** -6}
# The bound on band_rel_err(grouped kernel, grouped_matmul_ref) over
# block_t row bands: bf16, two bf16 epsilons (both sides round the f32 sum
# to bf16); f32, 2**-12, far above f32 rounding over d terms and far below
# what a lost or repeated 64-deep w chunk moves a band by.
GROUPED_BAND_TOL = {"float32": 2.0 ** -12, "bfloat16": 2.0 ** -6}


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


def pair_scores_ref(a, b, *, threshold: float = 0.8,
                    triangular: bool = False):
    """(M, d) × (N, d) → (M, N) f32: the f32 dot where it is >= threshold
    (compared in f32) and, with ``triangular``, row < col; 0 elsewhere.
    Same function as ``pair_sim.pair_scores``."""
    with full_precision():
        s = torch.einsum("md,nd->mn", a.to(torch.float32),
                         b.to(torch.float32))
    keep = s >= float(np.float32(threshold))
    if triangular:
        keep = keep & torch.ones_like(keep).triu(1)
    return torch.where(keep, s, torch.zeros((), device=s.device))


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
    weights, accumulated in f32 (TF32 off), cast to x's dtype; a tile whose
    expert id lies outside [0, E) gives zeros, as the kernel's does (the
    JAX reference's gather would clamp the id). The JAX reference gathers
    w per token; this gathers it per tile, which is the same function in
    1/block_t of the memory."""
    t, d = x.shape
    e = w.shape[0]
    te = tile_expert.long()
    live = (te >= 0) & (te < e)
    xt = x.reshape(t // block_t, block_t, d).to(torch.float32)
    with full_precision():
        out = torch.bmm(xt, w[te.clamp(0, e - 1)].to(torch.float32))
    out = torch.where(live[:, None, None], out, 0.0)
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


def band_rel_err(got, want, *, band: int = 64) -> float:
    """max |got - want| / max |want| over each band of ``band`` rows (the
    last may be short) of the (..., rows, cols) outputs, the largest over
    all bands. An absolute bound is set by the largest outputs; causal
    attention over a long S has small late rows, which a lost, repeated or
    badly rescaled kv tile moves by a share of their own magnitude. This
    holds every band to its own scale."""
    err = (got.float() - want.float()).abs().amax(-1)
    mag = want.float().abs().amax(-1)
    pad = -err.shape[-1] % band
    err = torch.nn.functional.pad(err, (0, pad)).unflatten(
        -1, (-1, band)).amax(-1)
    mag = torch.nn.functional.pad(mag, (0, pad)).unflatten(
        -1, (-1, band)).amax(-1)
    return (err / mag.clamp_min(torch.finfo(torch.float32).tiny)).max().item()

"""Mixture-of-Experts trunk (qwen3-moe / granite-moe), in PyTorch.

Port of ``repro.models.moe``. Attention is the dense GQA block; the FFN is
top-k routed over E experts, with the reference's two dispatch modes:

  * ``gshard`` (default) — capacity-based dispatch through a per-group
    sort and gathers (GShard semantics: overflow past the capacity
    ⌈cf·k·Tg/E⌉ drops).
  * ``grouped`` — tokens sorted by expert (the expert-load bincount is the
    BDM analog: experts are blocks, tokens are entities), laid out in
    tile-aligned segments and pushed through the grouped matmul
    (``ops.grouped_matmul``: the CUDA kernel on the card) without capacity
    drops. The serving path.

The grouped combine is deterministic: each (token, slot) output is placed
by a permutation and the k slots of a token are summed, where the
reference scatter-adds (``moe.py:216-217``) — on the card that would be
``index_add_`` atomics whose order, and so whose rounding, changes from
run to run.

Auxiliary load-balancing loss (Switch-style): E · Σ_e f_e · p_e.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..sharding import constrain
from . import transformer as _tf
from .config import ModelConfig
from .layers import dtype_of

__all__ = ["init", "empty", "forward", "init_cache", "prefill",
           "decode_step", "moe_ffn", "router_aux_loss", "grouped_layout"]


def spec(cfg: ModelConfig) -> Dict:
    """The dense trunk's spec with the FFN swapped for the router and the
    stacked expert weights."""
    d, e, fe = cfg.d_model, cfg.num_experts, cfg.d_expert
    dt = dtype_of(cfg.param_dtype)
    dense = ("dense", None)
    s = _tf.spec(cfg.replace(tie_embeddings=False))
    layer = s["layers"].layer
    for name in ("w_gate", "w_up", "w_down"):
        del layer[name]
    layer["router"] = ((d, e), dt, dense)
    layer["experts"] = {"w_gate": ((e, d, fe), dt, dense),
                        "w_up": ((e, d, fe), dt, dense),
                        "w_down": ((e, fe, d), dt, dense)}
    return s


def empty(cfg: ModelConfig, device="cuda") -> _tf.LanguageModel:
    """A model with uninitialised parameters on ``device``."""
    return _tf.LanguageModel(cfg, spec(cfg), _tf.resolve_device(device))


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random init, as ``transformer.init``."""
    return empty(cfg, device).init_(generator)


# ---------------------------------------------------------------------------
# MoE FFN
# ---------------------------------------------------------------------------

def _route(p, x, cfg: ModelConfig):
    """x: (T, d) → (weights (T, k), expert_ids (T, k), probs (T, E))."""
    probs = torch.softmax((x @ p.router).to(torch.float32), dim=-1)
    w, ids = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)  # renormalize
    return w.to(x.dtype), ids, probs


_MOE_GROUP_TOKENS = 4096  # target tokens per dispatch group


def _experts_gshard(p, x, w, ids, cfg: ModelConfig):
    """Grouped capacity dispatch via batched sort + gather (GShard
    semantics). x: (T, d) -> (T, d). Tokens split into G groups of ~4k;
    capacity C = ceil(cf·k·Tg/E) per expert and group; overflow drops
    first-come-first-served within the group. The reference's sharding
    hooks: G-batched tensors over every mesh axis, the expert buffer
    (G, E, C, d) E-over-``model`` (the EP all-to-all)."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    g_count = max(1, t // _MOE_GROUP_TOKENS)
    while t % g_count:
        g_count -= 1
    tg = t // g_count
    cap = max(1, -(-int(cfg.capacity_factor * k * tg) // e))
    tk = tg * k
    dev = x.device

    gall = ("pod", "data", "model")
    xg = constrain(x.reshape(g_count, tg, d), gall, None, None)
    w_flat = w.reshape(g_count, tk)
    flat_ids = ids.reshape(g_count, tk)
    order = torch.argsort(flat_ids, dim=1, stable=True)        # (G, Tk)
    sorted_ids = torch.gather(flat_ids, 1, order)
    counts = torch.zeros((g_count, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat_ids, torch.ones_like(flat_ids))
    start = torch.cat([counts.new_zeros((g_count, 1)),
                       torch.cumsum(counts, dim=1)[:, :-1]], dim=1)
    pos = (torch.arange(tk, device=dev)[None]
           - torch.gather(start, 1, sorted_ids))
    keep_sorted = pos < cap                                     # (G, Tk)

    # dispatch gather: slot (e, c) <- sorted position start[e] + c
    slot_src = start[:, :, None] + torch.arange(cap, device=dev)  # (G,E,C)
    slot_valid = (torch.arange(cap, device=dev)[None, None, :]
                  < torch.clamp(counts, max=cap)[:, :, None])
    slot_src = torch.clamp(slot_src, max=tk - 1).reshape(g_count, e * cap)
    src_token = constrain(torch.gather(order, 1, slot_src) // k, gall, None)
    xe = torch.gather(xg, 1, src_token[..., None].expand(-1, -1, d))
    xe = xe * slot_valid.reshape(g_count, e * cap, 1).to(xe.dtype)
    xe = constrain(xe, gall, None, None)
    xe = xe.reshape(g_count, e, cap, d)
    xe = constrain(xe, ("pod", "data"), "model", None, None)    # EP reshard
    ex = p.experts
    gt = torch.einsum("gecd,edf->gecf", xe, ex.w_gate)
    ut = torch.einsum("gecd,edf->gecf", xe, ex.w_up)
    ye = torch.einsum("gecf,efd->gecd", F.silu(gt) * ut, ex.w_down)
    ye = constrain(ye, ("pod", "data"), "model", None, None)

    # combine: loop the k slots
    ye_flat = constrain(ye.reshape(g_count, e * cap, d), gall, None, None)
    row = sorted_ids * cap + torch.clamp(pos, max=cap - 1)      # (G, Tk)
    row = torch.where(keep_sorted, row, e * cap - 1)
    inv = torch.argsort(order, dim=1)                           # slot -> sorted pos
    y = constrain(torch.zeros((g_count, tg, d), dtype=x.dtype, device=dev),
                  gall, None, None)
    for j in range(k):
        sorted_pos = inv[:, j::k]                               # (G, Tg)
        rows_j = torch.gather(row, 1, sorted_pos)
        keep_j = torch.gather(keep_sorted, 1, sorted_pos)
        y_j = constrain(
            torch.gather(ye_flat, 1, rows_j[..., None].expand(-1, -1, d)),
            gall, None, None)
        scale = torch.where(keep_j, w_flat[:, j::k], 0.0)
        y = y + y_j * scale[..., None].to(y_j.dtype)
    return y.reshape(t, d).to(x.dtype)


def grouped_layout(ids, num_experts: int):
    """The reference's tile-aligned expert-sorted layout of ``ids`` (T, k):
    returns (order, dst, tile_expert, tp, block_t).

    ``order`` is the stable argsort of the flattened slots by expert;
    sorted slot i goes to padded row ``dst[i]``; every expert's segment is
    padded to a multiple of ``block_t`` (128, or 8 for small-batch decode:
    T·k < 128·E), inside the static length tp = (⌈T·k/block_t⌉ + E)·block_t;
    ``tile_expert`` (tp/block_t,) int32 names each tile's expert, clamped
    to E − 1 past the real rows (``moe.py:191-208`` of the reference)."""
    e = num_experts
    tk = ids.numel()
    bt = 128 if tk >= 128 * e else 8
    dev = ids.device
    flat_ids = ids.reshape(tk)
    order = torch.argsort(flat_ids, stable=True)
    # a scatter-add, not bincount: bincount reads max(ids) back to the host
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_ids, torch.ones_like(flat_ids))
    tp = (-(-tk // bt) + e) * bt
    padded = (counts + bt - 1) // bt * bt
    pend = torch.cumsum(padded, dim=0)
    pstart = pend - padded
    start = torch.cumsum(counts, dim=0) - counts
    seg_of = flat_ids[order]                  # expert of each sorted slot
    dst = pstart[seg_of] + (torch.arange(tk, device=dev) - start[seg_of])
    tile_expert = torch.clamp(
        torch.searchsorted(pend, torch.arange(tp // bt, device=dev) * bt,
                           right=True), max=e - 1).to(torch.int32)
    return order, dst, tile_expert, tp, bt


def _experts_grouped(p, x, w, ids, cfg: ModelConfig, impl: str = "auto"):
    """Sort-by-expert + grouped matmul (tile-aligned, drop-free)."""
    t, d = x.shape
    k = cfg.top_k
    order, dst, tile_expert, tp, bt = grouped_layout(ids, cfg.num_experts)
    xg = torch.zeros((tp, d), dtype=x.dtype, device=x.device)
    xg[dst] = x[order // k]
    ex = p.experts
    g = ops.grouped_matmul(xg, tile_expert, ex.w_gate, block_t=bt, impl=impl)
    u = ops.grouped_matmul(xg, tile_expert, ex.w_up, block_t=bt, impl=impl)
    yg = ops.grouped_matmul((F.silu(g) * u).to(x.dtype), tile_expert,
                            ex.w_down, block_t=bt, impl=impl)
    # yg[dst[i]] is the output of sorted slot i = original slot order[i]
    y_slot = torch.empty((t * k, d), dtype=x.dtype, device=x.device)
    y_slot[order] = yg[dst] * w.reshape(t * k)[order][:, None]
    return y_slot.reshape(t, k, d).sum(dim=1)


def moe_ffn(p, x, cfg: ModelConfig):
    """x: (B, S, d) → (y, aux_loss)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    w, ids, probs = _route(p, xt, cfg)
    if cfg.moe_dispatch == "grouped":
        y = _experts_grouped(p, xt, w, ids, cfg, impl=cfg.kernel_impl)
    else:
        y = _experts_gshard(p, xt, w, ids, cfg)
    return y.reshape(b, s, d), router_aux_loss(ids, probs, cfg)


def router_aux_loss(ids, probs, cfg: ModelConfig):
    e = cfg.num_experts
    # the one-hot by comparison: F.one_hot reads min/max back to the host
    # on the CPU, and cannot on the meta device
    top = ids[:, :1] == torch.arange(e, device=ids.device)
    f = top.to(torch.float32).mean(dim=0)
    return e * torch.sum(f * probs.mean(dim=0))


def _ffn(p, h, cfg: ModelConfig):
    return moe_ffn(p, h, cfg)[0]


# ---------------------------------------------------------------------------
# Trunk: the dense trunk with the MoE FFN
# ---------------------------------------------------------------------------

def _body(h, p, cfg: ModelConfig, sin, cos):
    """One layer of ``forward``: (h, the layer's router aux loss)."""
    aux = []

    def ffn(p, x, cfg):
        y, a = moe_ffn(p, x, cfg)
        aux.append(a)
        return y

    h, _ = _tf.layer(h, p, cfg, sin, cos, ffn)
    return h, aux[0]


def forward(params, batch, cfg: ModelConfig, return_aux: bool = False,
            device="cuda"):
    """tokens (B, S) → logits (and the mean router aux loss, which carries
    its gradient to the routers). Differentiable, as
    ``transformer.forward``."""
    logits, aux = _tf.forward_extras(params, batch, cfg, device=device,
                                     body=_body)
    if return_aux:
        return logits, torch.stack(aux).sum() / cfg.n_layers
    return logits


init_cache = _tf.init_cache


def prefill(params, batch, cfg: ModelConfig, cache, device="cuda"):
    return _tf.prefill(params, batch, cfg, cache, device=device, ffn=_ffn)


def decode_step(params, tokens, cache, cfg: ModelConfig, device="cuda"):
    return _tf.decode_step(params, tokens, cache, cfg, device=device,
                           ffn=_ffn)

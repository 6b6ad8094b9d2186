"""Zamba2 hybrid: a Mamba2 (SSD) backbone plus one *shared* attention
block applied after every ``shared_attn_every`` layers, in PyTorch —
arXiv:2411.15242.

Port of ``repro.models.zamba2``. A Mamba2 layer (state-space duality,
scalar-per-head A):

    xBC = causal_conv1d(in_proj_x(x))           (kernel 4, depthwise)
    h_t = exp(−Δ_t·exp(A_log)) · h_{t−1} + Δ_t · B_t ⊗ x_t
    y_t = C_t · h_t + D · x_t ;  out = out_proj(y · silu(z))

The state per head is (head_dim, d_state), f32, so decode is O(1) in the
context. The recurrence runs as a Python loop over the steps and, under
autograd, in checkpointed chunks of 256 steps (as the reference's
rematted chunk scan).

The shared block reuses ONE parameter set at every application (the
dense trunk's pre-norm block: ``transformer.layer`` / ``decode_layer``
on the ``shared_attn`` node) and keeps its own KV cache per application.
Its attention takes ``cfg.attn_impl``: the kernel route runs the flash
kernel (head dim 80 at full size). Parameters: ``blocks`` holds the
``n_layers`` Mamba2 layers in order (the reference's ``(n_super, every,
…)`` leaves, flattened), super-block ``i`` being ``blocks[i·every :
(i+1)·every]``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..sharding import act_constrain
from . import transformer as _tf
from .config import ModelConfig
from .layers import chunked_scan, dtype_of, remat, rms_norm, rope_tables

__all__ = ["init", "empty", "forward", "init_cache", "prefill",
           "decode_step"]


def _n_super(cfg: ModelConfig) -> int:
    if cfg.shared_attn_every <= 0 or cfg.n_layers % cfg.shared_attn_every:
        raise ValueError(f"n_layers {cfg.n_layers} must be a multiple of "
                         f"shared_attn_every {cfg.shared_attn_every}")
    return cfg.n_layers // cfg.shared_attn_every


def _dims(cfg: ModelConfig):
    """(d_inner, d_state, heads, head dim, conv channels)."""
    di, ds = cfg.inner, cfg.ssm_state
    return di, ds, di // cfg.ssm_head_dim, cfg.ssm_head_dim, di + 2 * ds


def _mamba_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    di, _, nh, _, d_xbc = _dims(cfg)       # x, B, C share the conv
    dt = dtype_of(cfg.param_dtype)
    return {
        "ln": ((d,), dt, "ones"),
        "in_proj": ((d, d_xbc + di + nh), dt, ("dense", None)),
        "conv_w": ((d_xbc, cfg.conv_kernel), dt, ("dense", 0.5)),
        "conv_b": ((d_xbc,), dt, "zeros"),
        "A_log": ((nh,), dt, "zeros"),      # A = -exp(A_log) = -1
        "D": ((nh,), dt, "ones"),
        "dt_bias": ((nh,), dt, ("full", -2.0)),
        "out_proj": ((di, d), dt, ("dense", None)),
    }


def spec(cfg: ModelConfig) -> Dict:
    _n_super(cfg)
    dt = dtype_of(cfg.param_dtype)
    attn = _tf._layer_spec(cfg.replace(qkv_bias=False, qk_norm=False))
    return {"embed": ((cfg.vocab, cfg.d_model), dt, ("dense", 1.0)),
            "blocks": _tf.Stack(cfg.n_layers, _mamba_spec(cfg)),
            "shared_attn": attn,
            "ln_f": ((cfg.d_model,), dt, "ones"),
            "head": ((cfg.d_model, cfg.vocab), dt, ("dense", None))}


def empty(cfg: ModelConfig, device="cuda") -> _tf.LanguageModel:
    """A model with uninitialised parameters on ``device``."""
    return _tf.LanguageModel(cfg, spec(cfg), _tf.resolve_device(device))


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random init, as ``transformer.init``."""
    return empty(cfg, device).init_(generator)


# ---------------------------------------------------------------------------
# Mamba2 layer
# ---------------------------------------------------------------------------

def _causal_conv(x, w, b, state):
    """x (B, S, C), depthwise causal conv of kernel K = w.shape[1], after
    ``state`` (B, K-1, C), the prior context. Returns (silu(y), the new
    state)."""
    s, k = x.shape[1], w.shape[1]
    xp = torch.cat([state.to(x.dtype), x], dim=1)       # (B, S+K-1, C)
    y = sum(xp[:, i:i + s] * w[:, i] for i in range(k)) + b
    return F.silu(y), xp[:, -(k - 1):]


def _ssd_steps(state, xh, bmat, cmat, dt_, a):
    """The recurrence over the T = xh.shape[1] steps of xh (B, T, H, hd),
    bmat/cmat (B, T, ds), dt_ (B, T, H) f32 from ``state`` (B, H, hd, ds)
    f32: (y (B, T, H, hd), state)."""
    ys = []
    for t in range(xh.shape[1]):
        dtt = dt_[:, t]
        decay = torch.exp(dtt * a)                          # (B, H)
        xdt = xh[:, t] * dtt[..., None]                     # f32
        upd = xdt[..., :, None] * bmat[:, t, None, None, :].to(xdt.dtype)
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state.to(cmat.dtype),
                               cmat[:, t]))
    return torch.stack(ys, dim=1), state


def _mamba_layer(x, p, cfg: ModelConfig, ssm_state, conv_state):
    b, s, _ = x.shape
    di, ds, nh, hd, _ = _dims(cfg)
    h = rms_norm(x, p.ln, cfg.rms_eps)
    xbc, z, dt_raw = torch.split(h @ p.in_proj, [di + 2 * ds, di, nh],
                                 dim=-1)
    xbc, conv_state = _causal_conv(xbc, p.conv_w, p.conv_b, conv_state)
    xin, bmat, cmat = torch.split(xbc, [di, ds, ds], dim=-1)
    dt_ = F.softplus(dt_raw.to(torch.float32)
                     + p.dt_bias.to(torch.float32))         # (B, S, H)
    a = -torch.exp(p.A_log.to(torch.float32))
    xh = xin.reshape(b, s, nh, hd)
    # the recurrence state stays f32; the streams stay in the compute dtype
    y, ssm_state = chunked_scan(_ssd_steps, ssm_state,
                                (xh, bmat, cmat, dt_), (a,))
    y = y.to(x.dtype) + p.D[None, None, :, None] * xh
    y = y.reshape(b, s, di) * F.silu(z)
    return (act_constrain(x + y @ p.out_proj, cfg.act_shard), ssm_state,
            conv_state)


def _super_block(h, nodes, attn, cfg: ModelConfig, sin, cos, ssm, conv):
    """``every`` Mamba2 layers from states ssm (every, B, H, hd, ds) and
    conv (every, B, K-1, C), then the shared block. Returns (h, new ssm,
    new conv, (k, v) of the shared block)."""
    new_ssm, new_conv = [], []
    for j, p in enumerate(nodes):
        h, st, cv = _mamba_layer(h, p, cfg, ssm[j], conv[j])
        new_ssm.append(st)
        new_conv.append(cv)
    # the reference's shared block has its hook on the output only
    h, (k, v) = _tf.layer(h, attn, cfg, sin, cos, mid_constrain=False)
    return h, torch.stack(new_ssm), torch.stack(new_conv), k, v


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device="cuda"):
    """Per super-block: the Mamba2 layers' SSD (f32) and conv states and
    the shared block's KV cache of ``max_len`` positions."""
    dt = dtype_of(cfg.compute_dtype)
    dev = _tf.resolve_device(device)
    _, ds, nh, hd, d_xbc = _dims(cfg)
    n_sup, every, b = _n_super(cfg), cfg.shared_attn_every, batch_size
    kv = (n_sup, b, max_len, cfg.n_kv_heads, cfg.hd)
    return {"ssm": torch.zeros((n_sup, every, b, nh, hd, ds),
                               dtype=torch.float32, device=dev),
            "conv": torch.zeros((n_sup, every, b, cfg.conv_kernel - 1, d_xbc),
                                dtype=dt, device=dev),
            "k": torch.zeros(kv, dtype=dt, device=dev),
            "v": torch.zeros(kv, dtype=dt, device=dev),
            "pos": 0}


def _super_nodes(params, cfg: ModelConfig, i: int):
    every = cfg.shared_attn_every
    return list(params.blocks[i * every:(i + 1) * every])


def forward(params, batch, cfg: ModelConfig, device="cuda"):
    """tokens (B, S) → logits, from zero states. Differentiable, with
    ``cfg.remat`` per super-block (the reference remats the scanned
    super-block body)."""
    dev = _tf._check_device(params, device)
    h = _tf._embed_inputs(params, batch, cfg, dev)
    b, s = h.shape[:2]
    sin, cos = rope_tables(torch.arange(s, device=dev), cfg.hd,
                           cfg.rope_theta)
    zero = init_cache(cfg, b, 0, device=dev)
    for i in range(_n_super(cfg)):
        h = remat(_super_block, h, _super_nodes(params, cfg, i),
                  params.shared_attn, cfg, sin, cos, zero["ssm"][i],
                  zero["conv"][i], enabled=cfg.remat)[0]
    return _tf.final_logits(params, h, cfg)


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, cache, device="cuda"):
    """Run the prompt from the cache's SSD and conv states, writing them
    and the shared block's KV caches in place. Returns (logits of the
    last position (B, 1, V), cache)."""
    dev = _tf._check_device(params, device)
    h = _tf._embed_inputs(params, batch, cfg, dev)
    s = h.shape[1]
    if s > cache["k"].shape[2]:
        raise ValueError(f"prompt of {s} positions exceeds the cache's "
                         f"{cache['k'].shape[2]}")
    sin, cos = rope_tables(torch.arange(s, device=dev), cfg.hd,
                           cfg.rope_theta)
    for i in range(_n_super(cfg)):
        h, st, cv, k, v = _super_block(
            h, _super_nodes(params, cfg, i), params.shared_attn, cfg, sin,
            cos, cache["ssm"][i], cache["conv"][i])
        cache["ssm"][i] = st
        cache["conv"][i] = cv
        cache["k"][i, :, :s] = k.to(cache["k"].dtype)
        cache["v"][i, :, :s] = v.to(cache["v"].dtype)
    cache["pos"] = s
    return _tf.final_logits(params, h[:, -1:], cfg), cache


@torch.no_grad()
def decode_step(params, tokens, cache, cfg: ModelConfig, device="cuda"):
    """tokens (B, 1) → (logits (B, 1, V), cache): one step of every Mamba2
    layer, and the shared block against its cache at ``pos``."""
    dev = _tf._check_device(params, device)
    pos = cache["pos"]
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"the cache's {cache['k'].shape[2]} positions are "
                         "full")
    h = _tf._embed_inputs(params, {"tokens": tokens}, cfg, dev)
    sin, cos = rope_tables(torch.tensor([pos], device=dev), cfg.hd,
                           cfg.rope_theta)
    for i in range(_n_super(cfg)):
        for j, p in enumerate(_super_nodes(params, cfg, i)):
            h, st, cv = _mamba_layer(h, p, cfg, cache["ssm"][i, j],
                                     cache["conv"][i, j])
            cache["ssm"][i, j] = st
            cache["conv"][i, j] = cv
        h = _tf.decode_layer(h, params.shared_attn, cfg, sin, cos,
                             cache["k"][i], cache["v"][i], pos)
    cache["pos"] = pos + 1
    return _tf.final_logits(params, h, cfg), cache

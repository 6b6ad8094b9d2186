"""RWKV-6 "Finch" (attention-free, data-dependent decay), in PyTorch —
arXiv:2404.05892.

Port of ``repro.models.rwkv6``. Per layer: time-mix (the WKV recurrence)
and channel-mix. The WKV state is one (H, hd, hd) matrix per head,
updated per token as

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t
    y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)

with data-dependent decay w_t = exp(−exp(wx_t)), taken in f32. The state
is f32; ``y`` is computed in the compute dtype on the state cast to it,
as the reference does. The reference scans time with ``lax.scan``; the
port runs a Python loop over the steps, and under autograd checkpoints
each chunk of 256 steps (as the reference's rematted chunk scan), so the
backward keeps S/256 boundary states, not one per step.

Token shift mixes x_{t-1} into the projections; at t = 0 it reads the
cached last x (zeros for a fresh sequence). The cache is O(1) in the
sequence length: the WKV state and the two token-shift vectors per
layer, updated in place as the transformer's KV cache is.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..sharding import act_constrain
from . import transformer as _tf
from .config import ModelConfig
from .layers import chunked_scan, dtype_of, remat, rms_norm

__all__ = ["init", "empty", "forward", "init_cache", "prefill",
           "decode_step"]


def _layer_spec(cfg: ModelConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    dense, half = ("dense", None), ("full", 0.5)
    return {
        "ln_tm": ((d,), dt, "ones"),
        # token-shift mix coefficients per projection
        "mu_r": ((d,), dt, half), "mu_k": ((d,), dt, half),
        "mu_v": ((d,), dt, half), "mu_g": ((d,), dt, half),
        "mu_w": ((d,), dt, half),
        "w_r": ((d, d), dt, dense),
        "w_k": ((d, d), dt, dense),
        "w_v": ((d, d), dt, dense),
        "w_g": ((d, d), dt, dense),
        "w_decay": ((d, d), dt, ("dense", 0.01)),
        "w_decay_b": ((d,), dt, ("full", -6.0)),   # exp(-exp(-6)): slow
        "u_bonus": ((cfg.n_heads, cfg.hd), dt, "zeros"),
        "ln_x": ((d,), dt, "ones"),
        "w_wkv_out": ((d, d), dt, dense),
        "ln_cm": ((d,), dt, "ones"),
        "mu_ck": ((d,), dt, half),
        "cm_k": ((d, f), dt, dense),
        "cm_v": ((f, d), dt, dense),
        "cm_r": ((d, d), dt, dense),
    }


def spec(cfg: ModelConfig) -> Dict:
    dt = dtype_of(cfg.param_dtype)
    return {"embed": ((cfg.vocab, cfg.d_model), dt, ("dense", 1.0)),
            "layers": _tf.Stack(cfg.n_layers, _layer_spec(cfg)),
            "ln_f": ((cfg.d_model,), dt, "ones"),
            "head": ((cfg.d_model, cfg.vocab), dt, ("dense", None))}


def empty(cfg: ModelConfig, device="cuda") -> _tf.LanguageModel:
    """A model with uninitialised parameters on ``device``."""
    return _tf.LanguageModel(cfg, spec(cfg), _tf.resolve_device(device))


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random init, as ``transformer.init`` (mix coefficients 0.5, decay
    bias −6)."""
    return empty(cfg, device).init_(generator)


# ---------------------------------------------------------------------------
# Layer
# ---------------------------------------------------------------------------

def _shift(x, last=None):
    """x: (B, S, d) → x_{t-1}, with ``last`` (B, d) (zeros if None) at
    t = 0."""
    first = torch.zeros_like(x[:, :1]) if last is None \
        else last[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _wkv_steps(state, r, k, v, w, u):
    """The recurrence over the T = r.shape[1] steps of r/k/v/w (B, T, H,
    hd) from ``state`` (B, H, hd, hd) f32: (y (B, T, H, hd), state)."""
    uu = u[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # outer product
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               state.to(r.dtype) + uu * kv))
        state = w[:, t].to(state.dtype)[..., None] * state \
            + kv.to(state.dtype)
    return torch.stack(ys, dim=1), state


def _time_mix(p, x, cfg: ModelConfig, state, last_x):
    b, s, d = x.shape
    xs = _shift(x, last_x)

    def mix(mu):
        return x * mu + xs * (1 - mu)

    r = mix(p.mu_r) @ p.w_r
    k = mix(p.mu_k) @ p.w_k
    v = mix(p.mu_v) @ p.w_v
    g = mix(p.mu_g) @ p.w_g
    wx = mix(p.mu_w) @ p.w_decay + p.w_decay_b
    w = torch.exp(-torch.exp(wx.to(torch.float32))).to(x.dtype)
    shp = (b, s, cfg.n_heads, cfg.hd)
    # w is the decay in (0, 1), u_bonus (H, hd); the state stays f32
    y, state = chunked_scan(_wkv_steps, state, tuple(
        t.reshape(shp) for t in (r, k, v, w)), (p.u_bonus,))
    y = y.to(x.dtype)     # keep the layer carry in the compute dtype
    y = rms_norm(y.reshape(b, s, d), p.ln_x, cfg.rms_eps)
    y = y * F.silu(g)
    return y @ p.w_wkv_out, state, x[:, -1]


def _channel_mix(p, x, last_x):
    xs = _shift(x, last_x)
    xk = x * p.mu_ck + xs * (1 - p.mu_ck)
    kv = torch.square(F.relu(xk @ p.cm_k)) @ p.cm_v
    return torch.sigmoid(xk @ p.cm_r) * kv, x[:, -1]


def _layer(x, p, cfg: ModelConfig, state, last_tm, last_cm):
    h = rms_norm(x, p.ln_tm, cfg.rms_eps)
    y, state, new_tm = _time_mix(p, h, cfg, state, last_tm)
    x = act_constrain(x + y, cfg.act_shard)
    h = rms_norm(x, p.ln_cm, cfg.rms_eps)
    y, new_cm = _channel_mix(p, h, last_cm)
    return act_constrain(x + y, cfg.act_shard), state, new_tm, new_cm


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device="cuda"):
    """The WKV state (f32) and the two token-shift last-x vectors, per
    layer: O(1) in the sequence length (``max_len`` is not used)."""
    del max_len
    dt = dtype_of(cfg.compute_dtype)
    dev = _tf.resolve_device(device)
    L, b, d = cfg.n_layers, batch_size, cfg.d_model
    return {"wkv": torch.zeros((L, b, cfg.n_heads, cfg.hd, cfg.hd),
                               dtype=torch.float32, device=dev),
            "tm_x": torch.zeros((L, b, d), dtype=dt, device=dev),
            "cm_x": torch.zeros((L, b, d), dtype=dt, device=dev),
            "pos": 0}


def forward(params, batch, cfg: ModelConfig, device="cuda"):
    """tokens (B, S) → logits, from a zero state. Differentiable, with
    ``cfg.remat`` per layer, as ``transformer.forward``."""
    dev = _tf._check_device(params, device)
    h = _tf._embed_inputs(params, batch, cfg, dev)
    b = h.shape[0]
    state = torch.zeros((b, cfg.n_heads, cfg.hd, cfg.hd),
                        dtype=torch.float32, device=dev)
    for p in params.layers:
        h = remat(_layer, h, p, cfg, state, None, None,
                  enabled=cfg.remat)[0]
    return _tf.final_logits(params, h, cfg)


def _trunk(params, h, cfg: ModelConfig, cache):
    """Run the layers from the cache's states, writing the new ones in
    place."""
    for i, p in enumerate(params.layers):
        h, st, tm, cm = _layer(h, p, cfg, cache["wkv"][i], cache["tm_x"][i],
                               cache["cm_x"][i])
        cache["wkv"][i] = st
        cache["tm_x"][i] = tm
        cache["cm_x"][i] = cm
    cache["pos"] += h.shape[1]
    return h


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, cache, device="cuda"):
    """Run the prompt from the cache's states. Returns (logits of the last
    position (B, 1, V), cache), the cache updated in place."""
    dev = _tf._check_device(params, device)
    h = _tf._embed_inputs(params, batch, cfg, dev)
    h = _trunk(params, h, cfg, cache)
    return _tf.final_logits(params, h[:, -1:], cfg), cache


@torch.no_grad()
def decode_step(params, tokens, cache, cfg: ModelConfig, device="cuda"):
    """tokens (B, 1) → (logits (B, 1, V), cache), O(1) in the context."""
    dev = _tf._check_device(params, device)
    h = _tf._embed_inputs(params, {"tokens": tokens}, cfg, dev)
    h = _trunk(params, h, cfg, cache)
    return _tf.final_logits(params, h, cfg), cache

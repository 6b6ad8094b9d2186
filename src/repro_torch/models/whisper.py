"""Whisper-base (encoder-decoder, arXiv:2212.04356), transformer backbone
only, in PyTorch.

Port of ``repro.models.whisper``. The log-mel conv frontend is a stub, as
in the reference: ``batch["frames"]`` carries precomputed (B, n_frames,
d_model) frame embeddings. Encoder: bidirectional pre-LN MHA + GELU MLP
(tanh GELU, ``jax.nn.gelu``'s default) over the frames. Decoder: causal
self-attention, cross-attention to the encoder states, GELU MLP; logits
through the token embedding transposed. Positions are sinusoidal on both
sides (the reference swaps the decoder's learned table for sinusoids).

Decode cache: self-attention K/V (L, B, Smax, H, hd), updated in place,
and cross-attention K/V (L, B, n_audio_frames, H, hd), written once at
prefill from the encoder output.

Attention takes ``cfg.attn_impl``, as the reference's does; the kernel
route cannot serve whisper: the encoder is non-causal at a length that
is not a multiple of the flash kernel's kv tile, and cross-attention has
Sq ≠ Sk, so ``flash_attention.check_contract`` raises ``ValueError`` (as
the reference kernel raises). Whisper serves on the plain route.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..sharding import act_constrain
from . import transformer as _tf
from .config import ModelConfig
from .layers import (dtype_of, gqa_attention, gqa_attention_cached,
                     layer_norm, remat)

__all__ = ["init", "empty", "forward", "init_cache", "prefill",
           "decode_step", "encode"]


def _sinusoid(positions, d: int):
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / (half - 1))
    ang = positions.to(torch.float32)[:, None] * freq[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _attn_spec(cfg: ModelConfig) -> Dict:
    d, w = cfg.d_model, cfg.n_heads * cfg.hd
    dt = dtype_of(cfg.param_dtype)
    dense = ("dense", None)
    return {"wq": ((d, w), dt, dense), "wk": ((d, w), dt, dense),
            "wv": ((d, w), dt, dense), "wo": ((w, d), dt, dense),
            "bq": ((w,), dt, "zeros"), "bv": ((w,), dt, "zeros"),
            "bo": ((d,), dt, "zeros")}


def _enc_layer_spec(cfg: ModelConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    return {"ln1_w": ((d,), dt, "ones"), "ln1_b": ((d,), dt, "zeros"),
            "attn": _attn_spec(cfg),
            "ln2_w": ((d,), dt, "ones"), "ln2_b": ((d,), dt, "zeros"),
            "fc1": ((d, f), dt, ("dense", None)), "fc1_b": ((f,), dt, "zeros"),
            "fc2": ((f, d), dt, ("dense", None)), "fc2_b": ((d,), dt, "zeros")}


def _dec_layer_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    return {**_enc_layer_spec(cfg),
            "ln_x_w": ((d,), dt, "ones"), "ln_x_b": ((d,), dt, "zeros"),
            "xattn": _attn_spec(cfg)}


def spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    return {"embed": ((cfg.vocab, d), dt, ("dense", 1.0)),
            "enc_layers": _tf.Stack(cfg.n_encoder_layers,
                                    _enc_layer_spec(cfg)),
            "enc_ln_w": ((d,), dt, "ones"), "enc_ln_b": ((d,), dt, "zeros"),
            "dec_layers": _tf.Stack(cfg.n_layers, _dec_layer_spec(cfg)),
            "dec_ln_w": ((d,), dt, "ones"), "dec_ln_b": ((d,), dt, "zeros")}


def empty(cfg: ModelConfig, device="cuda") -> _tf.LanguageModel:
    """A model with uninitialised parameters on ``device``."""
    return _tf.LanguageModel(cfg, spec(cfg), _tf.resolve_device(device))


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random init, as ``transformer.init``."""
    return empty(cfg, device).init_(generator)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _project(p, xq, xkv, cfg: ModelConfig):
    """q (B, Sq, H, hd) of xq and k, v (B, Sk, H, hd) of xkv; wk has no
    bias."""
    b, s, _ = xq.shape
    h_, hd = cfg.n_heads, cfg.hd
    q = (xq @ p.wq + p.bq).reshape(b, s, h_, hd)
    k = (xkv @ p.wk).reshape(b, -1, h_, hd)
    v = (xkv @ p.wv + p.bv).reshape(b, -1, h_, hd)
    return q, k, v


def _out(p, o):
    return o.reshape(o.shape[0], o.shape[1], -1) @ p.wo + p.bo


def _mha(p, xq, xkv, cfg: ModelConfig, causal: bool):
    """Returns (attention output (B, Sq, d), (k, v))."""
    q, k, v = _project(p, xq, xkv, cfg)
    o = gqa_attention(q, k, v, causal=causal, impl=cfg.attn_impl,
                      kernel_impl=cfg.kernel_impl)
    return _out(p, o), (k, v)


def _mlp(p, x):
    h = F.gelu(x @ p.fc1 + p.fc1_b, approximate="tanh")
    return h @ p.fc2 + p.fc2_b


def _enc_layer(x, p, cfg: ModelConfig):
    a = layer_norm(x, p.ln1_w, p.ln1_b)
    x = x + _mha(p.attn, a, a, cfg, causal=False)[0]
    return act_constrain(x + _mlp(p, layer_norm(x, p.ln2_w, p.ln2_b)),
                         cfg.act_shard)


def _dec_layer(x, p, enc, cfg: ModelConfig):
    """One decoder block over a whole sequence: (x, self (k, v), cross
    (k, v))."""
    a = layer_norm(x, p.ln1_w, p.ln1_b)
    sa, self_kv = _mha(p.attn, a, a, cfg, causal=True)
    x = x + sa
    cx = layer_norm(x, p.ln_x_w, p.ln_x_b)
    ca, cross_kv = _mha(p.xattn, cx, enc, cfg, causal=False)
    x = x + ca
    return x + _mlp(p, layer_norm(x, p.ln2_w, p.ln2_b)), self_kv, cross_kv


def _dec_train_layer(x, p, enc, cfg: ModelConfig):
    """``forward``'s decoder block, with the reference's hook on its output
    (its prefill body has none)."""
    return act_constrain(_dec_layer(x, p, enc, cfg)[0], cfg.act_shard)


def _logits(params, h):
    h = layer_norm(h, params.dec_ln_w, params.dec_ln_b)
    return h @ params.embed.to(h.dtype).T


def _embed_tokens(params, tokens, pos0: int, cfg: ModelConfig, dev):
    tokens = torch.as_tensor(tokens, device=dev).long()
    dt = dtype_of(cfg.compute_dtype)
    pos = torch.arange(tokens.shape[1], device=dev) + pos0
    return params.embed[tokens].to(dt) + _sinusoid(pos, cfg.d_model).to(dt)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def encode(params, frames, cfg: ModelConfig, device="cuda"):
    """frames (B, F, d) stub embeddings → encoder states (B, F, d)."""
    dev = _tf._check_device(params, device)
    dt = dtype_of(cfg.compute_dtype)
    frames = torch.as_tensor(frames, device=dev)
    pos = torch.arange(frames.shape[1], device=dev)
    h = frames.to(dt) + _sinusoid(pos, cfg.d_model).to(dt)
    for p in params.enc_layers:
        h = _enc_layer(h, p, cfg)
    return layer_norm(h, params.enc_ln_w, params.enc_ln_b)


def forward(params, batch, cfg: ModelConfig, device="cuda"):
    """batch: frames (B, F, d) + tokens (B, S) → decoder logits.
    Differentiable; with ``cfg.remat`` each decoder layer runs under
    ``remat`` (the reference remats the decoder's scan body only)."""
    dev = _tf._check_device(params, device)
    enc = encode(params, batch["frames"], cfg, device=dev)
    h = _embed_tokens(params, batch["tokens"], 0, cfg, dev)
    for p in params.dec_layers:
        h = remat(_dec_train_layer, h, p, enc, cfg, enabled=cfg.remat)
    return _logits(params, h)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device="cuda"):
    dt = dtype_of(cfg.compute_dtype)
    dev = _tf.resolve_device(device)
    L, h_, hd = cfg.n_layers, cfg.n_heads, cfg.hd
    self_kv = (L, batch_size, max_len, h_, hd)
    cross_kv = (L, batch_size, cfg.n_audio_frames, h_, hd)
    return {"k": torch.zeros(self_kv, dtype=dt, device=dev),
            "v": torch.zeros(self_kv, dtype=dt, device=dev),
            "xk": torch.zeros(cross_kv, dtype=dt, device=dev),
            "xv": torch.zeros(cross_kv, dtype=dt, device=dev),
            "pos": 0}


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, cache, device="cuda"):
    """Encode the frames, write the cross K/V, run the prompt through the
    decoder writing the self-attention cache (all in place). Returns
    (logits of the last position (B, 1, V), cache)."""
    dev = _tf._check_device(params, device)
    enc = encode(params, batch["frames"], cfg, device=dev)
    if enc.shape[1] != cache["xk"].shape[2]:
        raise ValueError(f"{enc.shape[1]} frames; the cache holds "
                         f"{cache['xk'].shape[2]} (cfg.n_audio_frames)")
    x = _embed_tokens(params, batch["tokens"], 0, cfg, dev)
    s = x.shape[1]
    if s > cache["k"].shape[2]:
        raise ValueError(f"prompt of {s} positions exceeds the cache's "
                         f"{cache['k'].shape[2]}")
    for i, p in enumerate(params.dec_layers):
        x, (k, v), (xk, xv) = _dec_layer(x, p, enc, cfg)
        cache["k"][i, :, :s] = k.to(cache["k"].dtype)
        cache["v"][i, :, :s] = v.to(cache["v"].dtype)
        cache["xk"][i] = xk.to(cache["xk"].dtype)
        cache["xv"][i] = xv.to(cache["xv"].dtype)
    cache["pos"] = s
    return _logits(params, x[:, -1:]), cache


@torch.no_grad()
def decode_step(params, tokens, cache, cfg: ModelConfig, device="cuda"):
    """tokens (B, 1) → (logits (B, 1, V), cache): self-attention against
    the cache's [0, pos], cross-attention against every frame."""
    dev = _tf._check_device(params, device)
    pos = cache["pos"]
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"the cache's {cache['k'].shape[2]} positions are "
                         "full")
    x = _embed_tokens(params, tokens, pos, cfg, dev)
    for i, p in enumerate(params.dec_layers):
        a = layer_norm(x, p.ln1_w, p.ln1_b)
        q, k, v = _project(p.attn, a, a, cfg)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, pos] = k[:, 0].to(kc.dtype)
        vc[:, pos] = v[:, 0].to(vc.dtype)
        x = x + _out(p.attn, gqa_attention_cached(q, kc, vc, pos + 1))
        cx = layer_norm(x, p.ln_x_w, p.ln_x_b)
        qx = (cx @ p.xattn.wq + p.xattn.bq).reshape(
            cx.shape[0], 1, cfg.n_heads, cfg.hd)
        xk = cache["xk"][i]
        x = x + _out(p.xattn, gqa_attention_cached(qx, xk, cache["xv"][i],
                                                   xk.shape[1]))
        x = x + _mlp(p, layer_norm(x, p.ln2_w, p.ln2_b))
    cache["pos"] = pos + 1
    return _logits(params, x), cache

"""Dense GQA transformer trunk (llama3 / qwen3 / qwen1.5 / smollm /
phi-3-vision backbone), in PyTorch.

Port of ``repro.models.transformer``: the (forward, prefill, decode)
triple with a KV cache. The reference stacks its layers on a leading
axis and scans them; the port holds one parameter node per layer
(:class:`LanguageModel`) and runs them in a Python loop. The cache is
updated in place (``prefill`` and ``decode_step`` return the dict they
were given), and its write position ``pos`` is a Python int.

The VLM variant (phi-3-vision) prepends ``n_patches`` precomputed patch
embeddings (the reference's stubbed frontend) to the token embeddings;
everything downstream is the same trunk.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from ..device import resolve_device
from .config import ModelConfig
from .layers import (apply_rope, dense_init, dtype_of, gqa_attention,
                     gqa_attention_cached, rms_norm, rope_tables, swiglu)

__all__ = ["LanguageModel", "init", "empty", "forward", "init_cache",
           "prefill", "decode_step"]


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

class _Node(nn.Module):
    """One node of the parameter tree: parameters by name, child nodes for
    nested dicts (the MoE ``experts``)."""

    def __init__(self, spec: Dict, device):
        super().__init__()
        for name, val in spec.items():
            if isinstance(val, dict):
                self.add_module(name, _Node(val, device))
            else:
                shape, dtype, _ = val
                self.register_parameter(name, nn.Parameter(
                    torch.empty(shape, dtype=dtype, device=device),
                    requires_grad=False))


class LanguageModel(_Node):
    """The parameters of one model, named as the reference's params
    pytree: the top-level tensors (``embed``, ``ln_f``, ``head``,
    ``vis_proj``) and ``layers[i]``, one node per layer (the reference's
    ``params["layers"]`` leaves, unstacked). ``spec`` maps each name to
    (shape, dtype, init) with init ``"ones"``, ``"zeros"`` or
    ``("dense", scale)``; ``layers`` holds the spec of one layer."""

    def __init__(self, cfg: ModelConfig, spec: Dict, device):
        spec = dict(spec)
        layer = spec.pop("layers")
        super().__init__(spec, device)
        self.cfg = cfg
        self.layers = nn.ModuleList(_Node(layer, device)
                                    for _ in range(cfg.n_layers))
        self._spec = (spec, layer)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "LanguageModel":
        """Fill every parameter from ``generator`` (on this model's
        device), in a fixed order: top-level tensors, then layer by
        layer."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}: sample where the model lives")
        top, layer = self._spec
        _fill(self, top, generator)
        for node in self.layers:
            _fill(node, layer, generator)
        return self


def _fill(node, spec, generator):
    for name, val in spec.items():
        if isinstance(val, dict):
            _fill(getattr(node, name), val, generator)
            continue
        shape, dtype, how = val
        t = getattr(node, name)
        if how == "ones":
            t.fill_(1)
        elif how == "zeros":
            t.zero_()
        else:
            t.copy_(dense_init(shape, dtype, generator, scale=how[1]))


def _layer_spec(cfg: ModelConfig) -> Dict:
    d, hd, h, kv, f = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    dense = ("dense", None)
    p = {
        "ln_attn": ((d,), dt, "ones"),
        "wq": ((d, h * hd), dt, dense),
        "wk": ((d, kv * hd), dt, dense),
        "wv": ((d, kv * hd), dt, dense),
        "wo": ((h * hd, d), dt, dense),
        "ln_mlp": ((d,), dt, "ones"),
        "w_gate": ((d, f), dt, dense),
        "w_up": ((d, f), dt, dense),
        "w_down": ((f, d), dt, dense),
    }
    if cfg.qkv_bias:
        p["bq"] = ((h * hd,), dt, "zeros")
        p["bk"] = ((kv * hd,), dt, "zeros")
        p["bv"] = ((kv * hd,), dt, "zeros")
    if cfg.qk_norm:
        p["q_norm"] = ((hd,), dt, "ones")
        p["k_norm"] = ((hd,), dt, "ones")
    return p


def spec(cfg: ModelConfig) -> Dict:
    dt = dtype_of(cfg.param_dtype)
    s = {"embed": ((cfg.vocab, cfg.d_model), dt, ("dense", 1.0)),
         "layers": _layer_spec(cfg),
         "ln_f": ((cfg.d_model,), dt, "ones")}
    if not cfg.tie_embeddings:
        s["head"] = ((cfg.d_model, cfg.vocab), dt, ("dense", None))
    if cfg.family == "vlm":
        # stub frontend: a single projection of precomputed patch embeds
        s["vis_proj"] = ((cfg.d_model, cfg.d_model), dt, ("dense", None))
    return s


def empty(cfg: ModelConfig, device="cuda") -> LanguageModel:
    """A model with uninitialised parameters on ``device``."""
    return LanguageModel(cfg, spec(cfg), resolve_device(device))


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random init: truncated normal (±2σ) fan-in weights, ones for norm
    scales, zeros for biases, drawn from ``generator`` on ``device``."""
    return empty(cfg, device).init_(generator)


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------

def _check_device(params: LanguageModel, device) -> torch.device:
    dev = resolve_device(device)
    if params.device.type != dev.type or (
            dev.index is not None and params.device.index != dev.index):
        raise ValueError(f"the model lives on {params.device}, not on "
                         f"{dev}: pass device={str(params.device)!r}")
    return params.device


def _qkv(p, cfg: ModelConfig, x):
    b, s, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, cfg.n_heads, cfg.hd)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.rms_eps)
        k = rms_norm(k, p.k_norm, cfg.rms_eps)
    return q, k, v


def dense_ffn(p, h, cfg: ModelConfig):
    return swiglu(h, p.w_gate, p.w_up, p.w_down)


def layer(x, p, cfg: ModelConfig, sin, cos, ffn: Callable = dense_ffn):
    """One pre-norm block over a whole sequence: returns (x, (k, v))."""
    h = rms_norm(x, p.ln_attn, cfg.rms_eps)
    q, k, v = _qkv(p, cfg, h)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    attn = gqa_attention(q, k, v, causal=True, impl=cfg.attn_impl,
                         kernel_impl=cfg.kernel_impl)
    b, s = attn.shape[:2]
    x = x + attn.reshape(b, s, -1) @ p.wo
    h = rms_norm(x, p.ln_mlp, cfg.rms_eps)
    return x + ffn(p, h, cfg), (k, v)


def decode_layer(x, p, cfg: ModelConfig, sin, cos, k_cache, v_cache,
                 pos: int, ffn: Callable = dense_ffn):
    """One block for one new position per sequence: writes its k, v at
    ``pos`` of the layer's cache (in place) and attends to ``[0, pos]``."""
    hh = rms_norm(x, p.ln_attn, cfg.rms_eps)
    q, k, v = _qkv(p, cfg, hh)                    # (B, 1, ·, hd)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    attn = gqa_attention_cached(q, k_cache, v_cache, pos + 1)
    x = x + attn.reshape(x.shape[0], 1, -1) @ p.wo
    hh = rms_norm(x, p.ln_mlp, cfg.rms_eps)
    return x + ffn(p, hh, cfg)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------

def _tokens(batch, dev):
    return torch.as_tensor(batch["tokens"], device=dev).long()


def _embed_inputs(params, batch, cfg: ModelConfig, dev):
    dt = dtype_of(cfg.compute_dtype)
    h = params.embed[_tokens(batch, dev)].to(dt)
    if cfg.family == "vlm":
        patches = torch.as_tensor(batch["patches"], device=dev).to(dt)
        h = torch.cat([patches @ params.vis_proj.to(dt), h], dim=1)
    return h


def lm_head(params, h):
    """Logits; tied embeddings read the embedding matrix transposed."""
    if hasattr(params, "head"):
        return h @ params.head.to(h.dtype)
    return h @ params.embed.to(h.dtype).T


@torch.no_grad()
def forward(params, batch, cfg: ModelConfig, device="cuda",
            ffn: Callable = dense_ffn):
    """batch: tokens (B, S) [+ patches (B, Np, d) for vlm] → logits."""
    dev = _check_device(params, device)
    h = _embed_inputs(params, batch, cfg, dev)
    sin, cos = rope_tables(torch.arange(h.shape[1], device=dev), cfg.hd,
                           cfg.rope_theta)
    for p in params.layers:
        h, _ = layer(h, p, cfg, sin, cos, ffn)
    h = rms_norm(h, params.ln_f, cfg.rms_eps)
    if cfg.family == "vlm":
        h = h[:, -batch["tokens"].shape[1]:]
    return lm_head(params, h)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device="cuda"):
    dt = dtype_of(cfg.compute_dtype)
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev), "pos": 0}


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, cache, device="cuda",
            ffn: Callable = dense_ffn):
    """Run the prompt through the trunk, writing the KV cache in place.
    Returns (logits of the last position (B, 1, V), cache)."""
    dev = _check_device(params, device)
    h = _embed_inputs(params, batch, cfg, dev)
    s = h.shape[1]
    if s > cache["k"].shape[2]:
        raise ValueError(f"prompt of {s} positions exceeds the cache's "
                         f"{cache['k'].shape[2]}")
    sin, cos = rope_tables(torch.arange(s, device=dev), cfg.hd,
                           cfg.rope_theta)
    for i, p in enumerate(params.layers):
        h, (k, v) = layer(h, p, cfg, sin, cos, ffn)
        cache["k"][i, :, :s] = k.to(cache["k"].dtype)
        cache["v"][i, :, :s] = v.to(cache["v"].dtype)
    cache["pos"] = s
    h = rms_norm(h[:, -1:], params.ln_f, cfg.rms_eps)
    return lm_head(params, h), cache


@torch.no_grad()
def decode_step(params, tokens, cache, cfg: ModelConfig, device="cuda",
                ffn: Callable = dense_ffn):
    """tokens: (B, 1) — one new token per sequence; attends to
    cache[:pos + 1]. Returns (logits (B, 1, V), cache), the cache updated
    in place."""
    dev = _check_device(params, device)
    pos = cache["pos"]
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"the cache's {cache['k'].shape[2]} positions are "
                         "full")
    h = params.embed[torch.as_tensor(tokens, device=dev).long()].to(
        dtype_of(cfg.compute_dtype))                          # (B, 1, d)
    sin, cos = rope_tables(torch.tensor([pos], device=dev), cfg.hd,
                           cfg.rope_theta)                    # (1, hd/2)
    for i, p in enumerate(params.layers):
        h = decode_layer(h, p, cfg, sin, cos, cache["k"][i], cache["v"][i],
                         pos, ffn)
    cache["pos"] = pos + 1
    h = rms_norm(h, params.ln_f, cfg.rms_eps)
    return lm_head(params, h), cache

"""Dense GQA transformer trunk (llama3 / qwen3 / qwen1.5 / smollm /
phi-3-vision backbone), in PyTorch.

Port of ``repro.models.transformer``: the (forward, prefill, decode)
triple with a KV cache. The reference stacks its layers on a leading
axis and scans them; the port holds one parameter node per layer
(:class:`LanguageModel`, shared by every family) and runs them in a
Python loop. ``forward`` is differentiable (the train step's); serving
(``prefill``, ``decode_step``) runs under ``no_grad``. The cache is
updated in place (``prefill`` and ``decode_step`` return the dict they
were given), and its write position ``pos`` is a Python int.

The VLM variant (phi-3-vision) prepends ``n_patches`` precomputed patch
embeddings (the reference's stubbed frontend) to the token embeddings;
everything downstream is the same trunk.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from ..sharding import act_constrain
from .config import ModelConfig
from .layers import (apply_rope, dense_init, dtype_of, gqa_attention,
                     gqa_attention_cached, remat, rms_norm, rope_tables,
                     swiglu)

__all__ = ["LanguageModel", "Stack", "init", "empty", "forward",
           "forward_extras", "init_cache", "prefill", "decode_step"]


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


class Stack(NamedTuple):
    """The spec of ``n`` parameter nodes of one layer spec: the reference's
    layer-stacked leaves (leading axis ``n``), unstacked into one node
    each."""
    n: int
    layer: Dict


class LanguageModel(_Node):
    """The parameters of one model, named as the reference's params
    pytree: the top-level tensors (``embed``, ``ln_f``, ``head``, …),
    child nodes for nested dicts (zamba2's ``shared_attn``) and, for each
    :class:`Stack` of the spec, an ``nn.ModuleList`` of its nodes
    (``layers[i]``; zamba2's ``blocks``, whisper's ``enc_layers`` and
    ``dec_layers``). ``spec`` maps each name to (shape, dtype, init) with
    init ``"ones"``, ``"zeros"``, ``("full", value)`` or
    ``("dense", scale)``, to a dict, or to a :class:`Stack`."""

    def __init__(self, cfg: ModelConfig, spec: Dict, device):
        top = {k: v for k, v in spec.items() if not isinstance(v, Stack)}
        super().__init__(top, device)
        self.cfg = cfg
        self._stacks = {k: v for k, v in spec.items()
                        if isinstance(v, Stack)}
        for name, st in self._stacks.items():
            self.add_module(name, nn.ModuleList(
                _Node(st.layer, device) for _ in range(st.n)))
        self._top = top

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "LanguageModel":
        """Fill every parameter from ``generator`` (on this model's
        device), in a fixed order: top-level tensors, then each stack,
        node by node."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}: sample where the model lives")
        _fill(self, self._top, generator)
        for name, st in self._stacks.items():
            for node in getattr(self, name):
                _fill(node, st.layer, generator)
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
        elif how[0] == "full":
            t.fill_(how[1])
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
         "layers": Stack(cfg.n_layers, _layer_spec(cfg)),
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


def layer(x, p, cfg: ModelConfig, sin, cos, ffn: Callable = dense_ffn,
          mid_constrain: bool = True):
    """One pre-norm block over a whole sequence: returns (x, (k, v)). The
    reference's layer-boundary hooks: after the attention residual (unless
    ``mid_constrain`` is false, as in zamba2's shared block) and on the
    output."""
    h = rms_norm(x, p.ln_attn, cfg.rms_eps)
    q, k, v = _qkv(p, cfg, h)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    attn = gqa_attention(q, k, v, causal=True, impl=cfg.attn_impl,
                         kernel_impl=cfg.kernel_impl)
    b, s = attn.shape[:2]
    x = x + attn.reshape(b, s, -1) @ p.wo
    if mid_constrain:
        x = act_constrain(x, cfg.act_shard)
    h = rms_norm(x, p.ln_mlp, cfg.rms_eps)
    return act_constrain(x + ffn(p, h, cfg), cfg.act_shard), (k, v)


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


def final_logits(params, h, cfg: ModelConfig):
    """The final norm, then :func:`lm_head`."""
    return lm_head(params, rms_norm(h, params.ln_f, cfg.rms_eps))


def _dense_body(h, p, cfg: ModelConfig, sin, cos):
    return layer(h, p, cfg, sin, cos)[0], None


def forward(params, batch, cfg: ModelConfig, device="cuda"):
    """batch: tokens (B, S) [+ patches (B, Np, d) for vlm] → logits.

    Differentiable: under autograd (parameters that require grad) it
    builds the graph the train step differentiates, and with
    ``cfg.remat`` each layer runs under ``remat``."""
    return forward_extras(params, batch, cfg, device)[0]


def forward_extras(params, batch, cfg: ModelConfig, device="cuda",
                   body: Callable = _dense_body):
    """(logits, [body's extra per layer]): ``forward`` with ``body(h, p,
    cfg, sin, cos) -> (h, extra)`` as one layer (the MoE trunk's returns
    the layer's router aux loss)."""
    dev = _check_device(params, device)
    h = _embed_inputs(params, batch, cfg, dev)
    sin, cos = rope_tables(torch.arange(h.shape[1], device=dev), cfg.hd,
                           cfg.rope_theta)
    extras = []
    for p in params.layers:
        h, extra = remat(body, h, p, cfg, sin, cos, enabled=cfg.remat)
        extras.append(extra)
    h = rms_norm(h, params.ln_f, cfg.rms_eps)
    if cfg.family == "vlm":
        h = h[:, -batch["tokens"].shape[1]:]
    return lm_head(params, h), extras


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
    return final_logits(params, h[:, -1:], cfg), cache


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
    return final_logits(params, h, cfg), cache

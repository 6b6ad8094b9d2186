"""Shared building blocks of the LM families, in PyTorch.

Port of ``repro.models.layers``. Shapes, dtypes and the order of the
arithmetic follow the reference: norms in f32, the attention dot in the
activation dtype with the logits upcast after, softmax in f32.

Attention keeps the reference's g-major flat head layout (flat head
``h = g·KV + k`` reads KV head ``h % KV``; ``layers.py:84-88`` of the
reference). The kernel route permutes q into the h-major order of the
flash kernel (query head ``h' = k·G + g`` reads KV head ``h' // G``) and
the output back, so both routes, prefill and decode compute the same
function. The reference's own ``impl="pallas"`` route does not permute
and pairs heads differently from its ``"xla"`` route whenever G > 1;
the port does not copy that.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops

__all__ = ["dtype_of", "dense_init", "rms_norm", "layer_norm", "rope_tables",
           "apply_rope", "gqa_attention", "gqa_attention_cached", "swiglu"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def dense_init(shape, dtype, generator: torch.Generator, scale=None):
    """Truncated-normal (±2σ) fan-in init on the generator's device:
    σ = ``scale`` or fan_in ** -0.5, fan_in = shape[-2] (shape[-1] for a
    vector), sampled in f32 and cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * std).to(dtype)


def rms_norm(x, w, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.to(torch.float32)).to(dt)


def layer_norm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * w + b).to(dt)


def rope_tables(positions, head_dim: int, theta: float):
    """positions: (...,) int → (sin, cos) of shape (..., head_dim // 2)."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (..., S, H, D); sin/cos: (..., S, D // 2) broadcast over heads
    (rotate-half convention)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s = sin[..., None, :] if x.dim() == sin.dim() + 2 else sin
    c = cos[..., None, :] if x.dim() == cos.dim() + 2 else cos
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


_ATTN_CHUNK = 1024  # q-chunk of the plain route (bounds transients)


def gqa_attention(q, k, v, *, causal: bool = True, impl: str = "plain",
                  kernel_impl: str = "auto"):
    """q: (B, S, H, D); k/v: (B, S, KV, D), g-major heads. Returns
    (B, S, H, D).

    ``impl="plain"`` runs the reference's chunked attention: queries in
    chunks of 1024 so the (B, H, S, S) logits never materialize at once.
    ``impl="kernel"`` runs ``ops.attention`` (impl ``kernel_impl``) on
    h-major copies of q, k and v and permutes the output back."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    group = h // kv
    if impl == "kernel":
        # g-major (b, s, G, KV, d) -> h-major (b, KV·G, s, d)
        # (a copy: at G = 1 the reshape is a strided view, and the kernel
        # takes contiguous tensors)
        qh = q.reshape(b, s, group, kv, d).permute(0, 3, 2, 1, 4) \
            .reshape(b, h, s, d).contiguous()
        out = ops.attention(qh, k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(), causal=causal,
                            impl=kernel_impl)
        return out.reshape(b, kv, group, s, d).permute(0, 3, 2, 1, 4) \
            .reshape(b, s, h, d)
    if impl != "plain":
        raise ValueError(f"attention impl {impl!r}: expected 'plain' or "
                         "'kernel'")

    def chunk_attn(q_chunk, q_off):
        cq = q_chunk.shape[1]
        qg = q_chunk.reshape(b, cq, group, kv, d)
        # dot in the activation dtype, logits upcast after (as the reference)
        logits = torch.einsum("bqgkd,bskd->bgkqs", qg, k
                              ).to(torch.float32) * (d ** -0.5)
        if causal:
            rows = q_off + torch.arange(cq, device=q.device)[:, None]
            cols = torch.arange(s, device=q.device)[None, :]
            logits = torch.where(rows >= cols, logits, -1e30)
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bgkqs,bskd->bqgkd", p.to(v.dtype), v)
        return out.reshape(b, cq, h, d)

    if s <= _ATTN_CHUNK or s % _ATTN_CHUNK != 0:
        return chunk_attn(q, 0)
    return torch.cat([chunk_attn(q[:, i:i + _ATTN_CHUNK], i)
                      for i in range(0, s, _ATTN_CHUNK)], dim=1)


def gqa_attention_cached(q, k_cache, v_cache, cur_len: int):
    """Single-position decode: q (B, 1, H, D) against the first ``cur_len``
    positions of a (B, Smax, KV, D) cache (the reference masks the rest to
    -1e30, whose softmax weight is exactly 0). Returns (B, 1, H, D)."""
    b, _, h, d = q.shape
    kv = k_cache.shape[2]
    group = h // kv
    qg = q.reshape(b, group, kv, d)   # g-major, matching gqa_attention
    kc, vc = k_cache[:, :cur_len], v_cache[:, :cur_len]
    logits = torch.einsum("bgkd,bskd->bgks", qg, kc
                          ).to(torch.float32) * (d ** -0.5)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgks,bskd->bgkd", p.to(vc.dtype), vc)
    return out.reshape(b, 1, h, d)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down

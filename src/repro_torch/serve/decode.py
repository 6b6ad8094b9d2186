"""Serving: batched prefill + autoregressive decode, in PyTorch.

Port of ``repro.serve.decode``. ``generate`` runs the prefill and then a
Python loop of decode steps (the reference scans them), greedy or with
temperature sampling from an explicit ``torch.Generator``. The reference
scans ``max_new_tokens`` decode steps and drops the last step's token; the
port runs ``max_new_tokens − 1`` steps and returns the same tokens.

Every family serves through it: the cache is the family's
``init_cache(cfg, B, S + prefix + max_new_tokens)`` (the transformer's
KV cache; rwkv6's O(1) recurrent state, which ignores the length;
zamba2's states plus one KV cache per shared-block application;
whisper's self-attention cache plus the cross K/V that prefill writes
from ``batch["frames"]``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..device import resolve_device
from ..models import get_model
from ..models.config import ModelConfig

__all__ = ["make_prefill", "make_decode_step", "generate"]


def make_prefill(cfg: ModelConfig, device="cuda") -> Callable:
    mod = get_model(cfg)

    def prefill(params, batch, cache):
        return mod.prefill(params, batch, cfg, cache, device=device)

    return prefill


def make_decode_step(cfg: ModelConfig, device="cuda") -> Callable:
    mod = get_model(cfg)

    def decode_step(params, tokens, cache):
        return mod.decode_step(params, tokens, cache, cfg, device=device)

    return decode_step


@torch.no_grad()
def generate(params, cfg: ModelConfig, batch: Dict, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             cache_len: Optional[int] = None, device="cuda") -> torch.Tensor:
    """Greedy / temperature generation. ``batch`` holds 'tokens' (B, S)
    (+ 'patches' for vlm, 'frames' for audio), tensors or arrays. Returns
    (B, max_new_tokens) int32 on ``device``. Temperature sampling draws
    from ``generator`` (on ``device``; seed 0 when not given)."""
    dev = resolve_device(device)
    mod = get_model(cfg)
    b, s = batch["tokens"].shape
    prefix = cfg.n_patches if cfg.family == "vlm" else 0  # prefill writes it
    cache = mod.init_cache(cfg, b, cache_len or (s + prefix + max_new_tokens),
                           device=dev)
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(dev).manual_seed(0)

    def sample(logits):
        if temperature <= 0.0:
            return torch.argmax(logits[:, -1], dim=-1)
        probs = torch.softmax(logits[:, -1].to(torch.float32) / temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    if max_new_tokens <= 0:
        return torch.zeros((b, 0), dtype=torch.int32, device=dev)
    logits, cache = mod.prefill(params, batch, cfg, cache, device=dev)
    toks = [sample(logits)]
    for _ in range(max_new_tokens - 1):
        logits, cache = mod.decode_step(params, toks[-1][:, None], cache, cfg,
                                        device=dev)
        toks.append(sample(logits))
    return torch.stack(toks, dim=1).to(torch.int32)

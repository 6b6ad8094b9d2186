"""Config registry: arch name → ModelConfig, plus reduced smoke-test
configs. Copy of ``repro.configs`` without ``input_specs`` (the reference's
dry-run stand-ins) and the dry-run shape table."""
from __future__ import annotations

from typing import Dict

from ..models.config import ModelConfig
from . import (granite_moe_1b_a400m, llama3_2_3b, phi_3_vision_4_2b,
               qwen1_5_4b, qwen3_4b, qwen3_moe_235b_a22b, rwkv6_7b,
               smollm_360m, whisper_base, zamba2_2_7b)

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (llama3_2_3b, qwen3_4b, qwen1_5_4b, smollm_360m,
              qwen3_moe_235b_a22b, granite_moe_1b_a400m, phi_3_vision_4_2b,
              rwkv6_7b, zamba2_2_7b, whisper_base)
}

__all__ = ["ARCHS", "get_config", "reduced"]


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(
            f"unknown arch {name!r}; available: {sorted(ARCHS)}") from None


def reduced(cfg: ModelConfig, vocab: int = 512) -> ModelConfig:
    """Same-family shrunken config for CPU smoke tests: few layers, small
    width/experts/tables, full code path."""
    kw = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4),
        head_dim=16, d_ff=min(cfg.d_ff, 128) if cfg.d_ff else 0,
        vocab=vocab, param_dtype="float32", compute_dtype="float32",
        remat=False,
    )
    if cfg.n_kv_heads == cfg.n_heads:
        kw["n_kv_heads"] = 4
    else:
        kw["n_kv_heads"] = 2
    if cfg.family == "moe":
        kw.update(num_experts=min(cfg.num_experts, 8), top_k=min(cfg.top_k, 2),
                  d_expert=32, capacity_factor=8.0)
    if cfg.family == "ssm":
        kw.update(n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128)
    if cfg.family == "hybrid":
        kw.update(n_layers=4, shared_attn_every=2, ssm_state=16,
                  ssm_head_dim=16, d_inner=128, d_ff=128)
    if cfg.family == "audio":
        kw.update(n_encoder_layers=2, n_audio_frames=8)
    if cfg.family == "vlm":
        kw.update(n_patches=4)
    return cfg.replace(**kw)

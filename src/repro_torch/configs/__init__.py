"""Config registry: arch name → ModelConfig, plus input_specs and
reduced smoke-test configs. Copy of ``repro.configs``."""
from __future__ import annotations

from typing import Dict

import torch

from ..models.config import ModelConfig
from ..models.layers import dtype_of
from . import (granite_moe_1b_a400m, llama3_2_3b, phi_3_vision_4_2b,
               qwen1_5_4b, qwen3_4b, qwen3_moe_235b_a22b, rwkv6_7b,
               smollm_360m, whisper_base, zamba2_2_7b)
from .shapes import SHAPES, Shape, applicable, skip_reason  # noqa: F401

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (llama3_2_3b, qwen3_4b, qwen1_5_4b, smollm_360m,
              qwen3_moe_235b_a22b, granite_moe_1b_a400m, phi_3_vision_4_2b,
              rwkv6_7b, zamba2_2_7b, whisper_base)
}

__all__ = ["ARCHS", "SHAPES", "get_config", "reduced", "input_specs",
           "applicable", "skip_reason"]


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


def input_specs(cfg: ModelConfig, shape: Shape, dtype=torch.int32):
    """Meta-tensor stand-ins (shape and dtype, no storage) for every model
    input of one cell, as the reference's ``ShapeDtypeStruct``s.

    train  → {'tokens': (B, S), 'labels': (B, S)} (+ modality extras)
    prefill→ {'tokens': (B, S)} (+ extras); cache built separately
    decode → {'tokens': (B, 1)}; cache of length S built separately

    The extras (vlm ``patches``, audio ``frames``) are in the compute
    dtype."""
    b, s = shape.global_batch, shape.seq_len
    act = dtype_of(cfg.compute_dtype)

    def sds(dims, dt):
        return torch.empty(dims, dtype=dt, device="meta")

    if shape.kind == "train":
        batch = {"tokens": sds((b, s), dtype), "labels": sds((b, s), dtype)}
    elif shape.kind == "prefill":
        batch = {"tokens": sds((b, s), dtype)}
    else:
        batch = {"tokens": sds((b, 1), dtype)}
    if cfg.family == "vlm" and shape.kind != "decode":
        batch["patches"] = sds((b, cfg.n_patches, cfg.d_model), act)
    if cfg.family == "audio" and shape.kind != "decode":
        batch["frames"] = sds((b, cfg.n_audio_frames, cfg.d_model), act)
    return batch

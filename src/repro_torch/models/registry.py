"""Family → module dispatch. Every family exposes the same functional
surface (init / empty / forward / init_cache / prefill / decode_step)."""
from __future__ import annotations

from types import ModuleType

from . import moe, rwkv6, transformer, whisper, zamba2
from .config import ModelConfig

__all__ = ["MODEL_FAMILIES", "get_model"]

MODEL_FAMILIES = {
    "dense": transformer,
    "vlm": transformer,
    "moe": moe,
    "ssm": rwkv6,
    "hybrid": zamba2,
    "audio": whisper,
}


def get_model(cfg: ModelConfig) -> ModuleType:
    try:
        return MODEL_FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family {cfg.family!r}") from None

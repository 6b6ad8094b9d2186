"""Family → module dispatch. Every family ported so far exposes the same
functional surface (init / empty / forward / init_cache / prefill /
decode_step)."""
from __future__ import annotations

from types import ModuleType

from . import moe, transformer
from .config import ModelConfig

__all__ = ["MODEL_FAMILIES", "get_model"]

MODEL_FAMILIES = {
    "dense": transformer,
    "vlm": transformer,
    "moe": moe,
}

# Families of the reference not ported yet, with the ROADMAP item that
# ports them.
_LATER = {
    "ssm": "rwkv6 (models/rwkv6.py)",
    "hybrid": "zamba2 (models/zamba2.py)",
    "audio": "whisper (models/whisper.py)",
}


def get_model(cfg: ModelConfig) -> ModuleType:
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({_LATER[cfg.family]}) is not "
            "ported yet: ROADMAP.md Queue 1 item 11")
    try:
        return MODEL_FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family {cfg.family!r}") from None

"""LM families of the port: dense / vlm (``transformer``) and moe.

Every family module exposes
    init(cfg, generator, device)              -> LanguageModel (nn.Module)
    empty(cfg, device)                        -> LanguageModel, uninitialised
    forward(params, batch, cfg, device)       -> logits
    init_cache(cfg, batch, seq, device)       -> cache dict
    prefill(params, batch, cfg, cache, device)-> (logits, cache)
    decode_step(params, toks, cache, cfg, device) -> (logits, cache)

as ``repro.models`` does, with an ``nn.Module`` in place of the params
pytree. Families ``ssm``, ``hybrid`` and ``audio`` raise
``NotImplementedError`` from :func:`get_model`.
"""
from .config import ModelConfig  # noqa: F401
from .registry import MODEL_FAMILIES, get_model  # noqa: F401

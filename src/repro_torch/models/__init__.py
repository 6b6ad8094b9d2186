"""The LM families of the port: dense / vlm (``transformer``), moe, ssm
(``rwkv6``), hybrid (``zamba2``) and audio (``whisper``).

Every family module exposes
    init(cfg, generator, device)              -> LanguageModel (nn.Module)
    empty(cfg, device)                        -> LanguageModel, uninitialised
    forward(params, batch, cfg, device)       -> logits
    init_cache(cfg, batch, seq, device)       -> cache dict
    prefill(params, batch, cfg, cache, device)-> (logits, cache)
    decode_step(params, toks, cache, cfg, device) -> (logits, cache)

as ``repro.models`` does, with an ``nn.Module`` in place of the params
pytree (``transformer.LanguageModel``). ``forward`` is differentiable
(the train step's); serving runs under ``no_grad``. Whisper's batch also
carries ``frames`` (B, n_audio_frames, d_model), the stub frontend's.
"""
from .config import ModelConfig  # noqa: F401
from .registry import MODEL_FAMILIES, get_model  # noqa: F401

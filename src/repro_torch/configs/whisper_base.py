"""whisper-base [audio] — enc-dec 6L+6L d_model=512 8H d_ff=2048
vocab=51865; conv/log-mel frontend is a STUB (input_specs feeds
precomputed (B, 1500, d_model) frame embeddings). [arXiv:2212.04356]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab=51865,
    n_encoder_layers=6,
    n_audio_frames=1500,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    act_shard="seq",
)

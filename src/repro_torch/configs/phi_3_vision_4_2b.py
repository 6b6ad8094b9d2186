"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064; phi3-mini backbone + CLIP frontend (STUB: input_specs feeds
precomputed (B, n_patches, d_model) patch embeddings).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab=32064,
    rope_theta=10_000.0,
    n_patches=576,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    act_shard="seq",
)

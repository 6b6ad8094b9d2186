"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk_norm. [hf:Qwen/Qwen3-4B; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    rms_eps=1e-6,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    act_shard="seq",
)

"""qwen1.5-4b [dense] — 40L d_model=2560 20H (GQA kv=20, i.e. MHA)
d_ff=6912 vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-4B; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    rms_eps=1e-6,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    act_shard="seq",
)

"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8)
expert d_ff=512 vocab=49155, MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=0,
    vocab=49155,
    num_experts=32,
    top_k=8,
    d_expert=512,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    act_shard="seq",
)

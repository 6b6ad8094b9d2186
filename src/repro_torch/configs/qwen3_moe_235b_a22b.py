"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4)
expert d_ff=1536 vocab=151936, MoE 128 experts top-8, qk_norm.
[hf:Qwen/Qwen3-235B-A22B; hf]

The big dry-run target: bf16 params + bf16 Adam moments + FSDP×EP
sharding are what make it fit 16 GiB/chip (EXPERIMENTS.md §Dry-run).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab=151936,
    qk_norm=True,
    num_experts=128,
    top_k=8,
    d_expert=1536,
    rope_theta=1_000_000.0,
    rms_eps=1e-6,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    act_shard="seq",
)

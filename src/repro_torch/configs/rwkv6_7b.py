"""rwkv6-7b [ssm] — Finch: 32L d_model=4096 (attention-free, 64 heads of
size 64) d_ff=14336 vocab=65536, data-dependent decay.
[arXiv:2404.05892; hf:RWKV/v6-Finch-7B-HF]

O(1)-state decode → qualifies for the long_500k shape."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # wkv heads = d_model / head_size(64)
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab=65536,
    subquadratic=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    act_shard="full_dp",
)

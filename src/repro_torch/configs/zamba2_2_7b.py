"""zamba2-2.7b [hybrid] — 54 Mamba2 layers d_model=2560 + ONE shared
attention block (32H MHA, d_ff=10240) applied every 6 layers;
ssm_state=64, vocab=32000. [arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B]

Mamba2 state is O(1) in context → qualifies for long_500k."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    d_inner=5120,
    shared_attn_every=6,
    subquadratic=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    act_shard="seq",
)

"""Architecture configuration shared by every model family.

Copy of ``repro.models.config.ModelConfig`` with the port's names for the
attention route: ``attn_impl`` is ``"plain"`` (the chunked attention of
``layers.gqa_attention`` in PyTorch; the reference's ``"xla"``) or
``"kernel"`` (``ops.attention``, the flash kernel on the card; the
reference's ``"pallas"``). ``kernel_impl`` is the port's own: the ``ops``
impl (``auto | cuda | torch``) of both kernel routes, the flash kernel and
the grouped matmul of ``moe_dispatch="grouped"``. ``remat`` checkpoints
each layer of a differentiated ``forward`` (``layers.remat``).
``act_shard`` is the mode of the layer-boundary sharding hooks
(``sharding.act_constrain``). The fields of the reference's layer scan
(``unroll_layers``, ``layer_unroll``) are kept as data; the port runs its
layers in a Python loop and reads neither.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

__all__ = ["ModelConfig", "ATTN_IMPLS"]

ATTN_IMPLS = ("plain", "kernel")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    qk_norm: bool = False           # qwen3
    qkv_bias: bool = False          # qwen1.5
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    top_k: int = 0
    d_expert: int = 0               # per-expert FFN hidden dim
    moe_dispatch: str = "gshard"    # gshard | grouped (paper-balanced)
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    d_inner: int = 0                # mamba expansion (default 2*d_model)
    shared_attn_every: int = 0      # zamba2: one shared attn block per N
    conv_kernel: int = 4
    # enc-dec (whisper)
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500      # stub frontend output length
    # vlm
    n_patches: int = 0              # stub patch-embedding prefix length
    # numerics / memory
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False
    attn_impl: str = "plain"        # plain | kernel (flash)
    kernel_impl: str = "auto"       # ops impl of the kernel routes
    unroll_layers: bool = False
    layer_unroll: int = 1
    act_shard: str = "none"
    # long-context capability flag (sub-quadratic decode state)
    subquadratic: bool = False

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r}: expected one "
                             f"of {ATTN_IMPLS}")
        if self.moe_dispatch not in ("gshard", "grouped"):
            raise ValueError(f"moe_dispatch {self.moe_dispatch!r}: expected "
                             "'gshard' or 'grouped'")

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def inner(self) -> int:
        return self.d_inner or (2 * self.d_model)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline numbers)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm"):
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            ffn = 3 * d * self.d_ff
            return emb + self.n_layers * (attn + ffn)
        if self.family == "moe":
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            moe = self.num_experts * 3 * d * self.d_expert + d * self.num_experts
            return emb + self.n_layers * (attn + moe)
        if self.family == "ssm":        # rwkv6
            tmix = 4 * d * d + d * d    # r,k,v,g + output
            cmix = 2 * d * self.d_ff if self.d_ff else 7 * d * d
            return emb + self.n_layers * (tmix + cmix)
        if self.family == "hybrid":     # zamba2
            di = self.inner
            mamba = d * (2 * di) + di * d + di * (2 * self.ssm_state)
            attn = 4 * d * d + 3 * d * self.d_ff
            return emb + self.n_layers * mamba + attn  # shared: counted once
        if self.family == "audio":
            enc = self.n_encoder_layers * (4 * d * d + 2 * d * self.d_ff)
            dec = self.n_layers * (8 * d * d + 2 * d * self.d_ff)
            return emb + enc + dec
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        attn = d * self.hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * self.hd * d
        moe_active = self.top_k * 3 * d * self.d_expert + d * self.num_experts
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * (attn + moe_active)

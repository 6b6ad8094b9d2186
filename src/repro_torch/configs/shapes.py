"""Input-shape set assigned to the LM architectures.

    train_4k      seq 4,096   global_batch 256   → train_step
    prefill_32k   seq 32,768  global_batch 32    → prefill (serve)
    decode_32k    seq 32,768  global_batch 128   → decode_step (one new
                                                   token, 32k KV cache)
    long_500k     seq 524,288 global_batch 1     → decode_step; requires
                                                   sub-quadratic decode
                                                   state (SSM/hybrid only)

``applicable(cfg, shape)`` encodes the skip rules (see DESIGN.md
§Arch-applicability): long_500k is skipped for pure full-attention archs
(a 512k dense-KV decode is the quadratic-prefill regime the shape
excludes); every other cell runs for all 10 archs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..models.config import ModelConfig

__all__ = ["Shape", "SHAPES", "applicable", "skip_reason"]


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: Shape) -> bool:
    return skip_reason(cfg, shape) is None


def skip_reason(cfg: ModelConfig, shape: Shape) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("pure full-attention arch: 512k dense-KV decode is the "
                "quadratic regime long_500k excludes (DESIGN.md "
                "§Arch-applicability)")
    return None

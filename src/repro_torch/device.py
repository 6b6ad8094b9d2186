"""Device resolution shared by the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``. Without a card
they raise unless the caller asked for the CPU: nothing moves to the CPU
by itself.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or "
                         "'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    return dev

"""Device resolution shared by the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``. Without a card
they raise unless the caller asked for the CPU: nothing moves to the CPU
by itself. ``"meta"`` (shapes and dtypes, no storage) is accepted when
the caller passes it: the dry-run (``launch/dryrun.py``) builds its cells
there.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda', 'cpu' "
                         "or 'meta'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    return dev


def synchronize(devices) -> None:
    """Wait for the work queued on every CUDA device among ``devices``
    (each distinct device once; CPU devices need no wait)."""
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

"""AdamW, hand-rolled over a model's parameters: global-norm clipping,
bias correction, decoupled weight decay, cosine LR schedule.

Port of ``repro.train.optimizer``. The state is ``{"m": {name: tensor},
"v": {name: tensor}, "step": int32 scalar}``: the moments by parameter
name on the parameters' devices, the step count on the host (reading it
waits for no device). ``moment_dtype="bfloat16"`` keeps the moments in
bf16 storage and updates them in f32 arithmetic, as the reference does.
``torch.optim.AdamW`` is not used: it has neither the bf16-moment mode
nor the clipping. ``adamw_update`` updates the parameters and the
moments in place.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "cosine_lr"]


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def _named(params) -> Dict[str, torch.Tensor]:
    """``params`` as {name: tensor}: a mapping, or an ``nn.Module``'s
    named parameters."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()):
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    named = _named(params)

    def zeros():
        return {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                for n, p in named.items()}

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (a 0-dim
    tensor on the tensors' device). ``tensors``: a mapping or an
    iterable."""
    if isinstance(tensors, Mapping):
        tensors = tensors.values()
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in tensors]
    return torch.sqrt(torch.stack(sq).sum())


def cosine_lr(step, *, peak: float, warmup: int = 100, total: int = 10_000,
              floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine to
    ``floor_frac · peak`` at ``total``; f32 arithmetic, as the reference
    computes it on an int32 step. Returns a 0-dim f32 host tensor."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak * (s + 1) / max(warmup, 1)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5
                  * (1 + torch.cos(torch.pi * t)))
    return torch.where(s < warmup, warm, cos)


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig = AdamWConfig(),
                 lr=None):
    """One AdamW step on ``params`` (a mapping name → tensor, or a module)
    from ``grads`` (name → tensor), in place. Returns (params, opt_state,
    {"grad_norm": the global norm before clipping})."""
    named = _named(params)
    step = opt_state["step"] + 1
    lr = cfg.lr if lr is None else float(lr)
    gnorm = global_norm([grads[n] for n in named])
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    t = step.to(torch.float32)
    f32 = torch.float32
    bc1 = float(1 - torch.tensor(cfg.b1, dtype=f32) ** t)
    bc2 = float(1 - torch.tensor(cfg.b2, dtype=f32) ** t)
    for n, p in named.items():
        m, v = opt_state["m"][n], opt_state["v"][n]
        g = grads[n].to(f32) * scale
        m32 = cfg.b1 * m.to(f32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(f32) + (1 - cfg.b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.to(f32)
        p.copy_(p.to(f32) - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm}

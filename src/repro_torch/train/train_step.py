"""Training step: loss, gradients, AdamW update, in PyTorch.

Port of ``repro.train.train_step``. The step runs eagerly, on the device
the model lives on: autograd through the family's differentiable
``forward`` (each layer under ``remat`` when ``cfg.remat``), then
``adamw_update`` in place. The hand-written kernels have no backward
(nor have the reference's Pallas kernels), so the step takes the plain
routes only: ``attn_impl="plain"`` and ``moe_dispatch="gshard"``, as the
reference's default routes (``attn_impl="xla"``, gshard).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models import get_model
from ..models.config import ModelConfig
from ..sharding import constrain
from .optimizer import AdamWConfig, adamw_update, cosine_lr

__all__ = ["loss_fn", "make_train_step"]


def loss_fn(params, batch, cfg: ModelConfig, aux_weight: float = 0.01):
    """Next-token cross entropy (labels = batch['labels'], −100 ignored),
    as logsumexp in f32, plus ``aux_weight`` × the MoE router auxiliary
    loss. Returns (loss, {"xent", "aux"}), on the model's device."""
    mod = get_model(cfg)
    dev = params.device
    if cfg.family == "moe":
        logits, aux = mod.forward(params, batch, cfg, return_aux=True,
                                  device=dev)
    else:
        logits = mod.forward(params, batch, cfg, device=dev)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, logz - gold, 0.0)
    xent = nll.sum() / torch.clamp(valid.sum(), min=1)
    return xent + aux_weight * aux, {"xent": xent, "aux": aux}


def make_train_step(cfg: ModelConfig, opt: AdamWConfig = AdamWConfig(),
                    total_steps: int = 10_000) -> Callable:
    """Returns step(params, opt_state, batch) → (params, opt_state,
    metrics) with metrics loss, lr, xent, aux and grad_norm (0-dim
    tensors). ``params`` (a ``LanguageModel``) and ``opt_state`` are
    updated in place and returned. The learning rate is the cosine
    schedule at ``opt_state["step"]`` before the update. Raises for the
    kernel routes, which have no backward."""
    if cfg.attn_impl == "kernel" or cfg.moe_dispatch == "grouped":
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r}, moe_dispatch={cfg.moe_dispatch!r}"
            ": the flash and grouped-matmul kernels have no backward; train "
            "with attn_impl='plain' and moe_dispatch='gshard'")

    def step(params, opt_state, batch):
        # every entry's batch dim over the DP axes, in the key order of
        # the reference's jitted step (a flattened dict's: sorted)
        batch = {k: constrain(batch[k], ("pod", "data"))
                 for k in sorted(batch)}
        named = dict(params.named_parameters())
        for p in named.values():
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, stats = loss_fn(params, batch, cfg)
                grads = torch.autograd.grad(loss, list(named.values()),
                                            allow_unused=True)
        finally:
            for p in named.values():
                p.requires_grad_(False)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(named.items(), grads)}
        lr = cosine_lr(opt_state["step"], peak=opt.lr, total=total_steps)
        _, opt_state, opt_stats = adamw_update(grads, opt_state, named,
                                               opt, lr=lr)
        metrics = {"loss": loss.detach(), "lr": lr,
                   **{k: v.detach() for k, v in stats.items()}, **opt_stats}
        return params, opt_state, metrics

    return step

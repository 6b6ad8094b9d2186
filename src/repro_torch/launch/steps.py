"""Cell builder: (arch config × input shape × mesh) → a step function,
its arguments and their per-argument specs. Shared by the dry-run, the
roofline harness and ``chip_smoke.py``'s phase DR.

Port of ``repro.launch.steps``. The steps are the port's own:
``train.make_train_step`` (AdamW, in place), the family's ``prefill``
and its ``decode_step``. On ``device="meta"`` (the default) nothing is
allocated: parameters, optimizer moments, caches and inputs are meta
tensors, and :func:`roofline.count_cost` runs the step on them. On a
real device the same cell holds random weights and inputs from a seeded
``torch.Generator``.

``layer_unroll`` reads differently from the reference's: the reference
scans its layers and compiles unroll factors 1 and 2 of one full-depth
scan; the port loops its layers in Python, so ``layer_unroll = u``
builds the cell at **u trips of depth** (``n_layers = u``; hybrid
``u · shared_attn_every``; audio both stacks at depth u) and the
dry-run extrapolates to :func:`scan_trips`.

A decode cell's cache holds a context of ``seq_len`` positions and its
step writes the last one (``pos = seq_len − 1``, the cache's last slot):
the port's cached attention reads ``cache[:, :pos + 1]``, so the new
token attends to the whole context, as ``decode_32k`` and ``long_500k``
mean. The step resets ``pos`` before each call, so repeated calls repeat
the same step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from .. import sharding as shd
from ..configs import Shape, input_specs
from ..device import resolve_device
from ..models import get_model
from ..models.config import ModelConfig
from ..train.optimizer import AdamWConfig, adamw_init
from ..train.train_step import make_train_step

__all__ = ["Cell", "build_cell", "make_step", "scan_trips"]

_BIG_PARAMS = 10_000_000_000  # bf16 Adam moments above this


@dataclass
class Cell:
    fn: Callable                 # the step: fn(*args)
    args: Tuple[Any, ...]        # (model, opt_state, batch) | (model, batch,
                                 # cache) | (model, tokens, cache)
    in_specs: Tuple[Any, ...]    # per arg: {name: P} trees, or one P
    kind: str                    # train | prefill | decode
    cfg: ModelConfig
    shape: Shape
    mesh: Any                    # sharding.AbstractMesh or sharding.Mesh
    batch_shards: int            # devices the batch dim is split over


def _opt_config(cfg: ModelConfig) -> AdamWConfig:
    big = cfg.param_count() > _BIG_PARAMS
    return AdamWConfig(moment_dtype="bfloat16" if big else "float32")


def scan_trips(cfg: ModelConfig) -> int:
    """Trip count of the (outer) layer loop — the extrapolation factor
    for two-point cost analysis."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    return cfg.n_layers


def _at_depth(cfg: ModelConfig, trips: int) -> ModelConfig:
    """``cfg`` at ``trips`` trips of its layer loop (see the module
    docstring); raises for an audio config whose two stacks differ in
    depth."""
    if cfg.family == "hybrid":
        return cfg.replace(n_layers=trips * cfg.shared_attn_every)
    if cfg.family == "audio":
        if cfg.n_encoder_layers != cfg.n_layers:
            raise ValueError(f"{cfg.name}: encoder depth "
                             f"{cfg.n_encoder_layers} != decoder depth "
                             f"{cfg.n_layers}; one trip must cover one "
                             "layer of each stack")
        return cfg.replace(n_layers=trips, n_encoder_layers=trips)
    return cfg.replace(n_layers=trips)


def make_step(cfg: ModelConfig, kind: str, device, pos: int = 0):
    """The step function of a cell of ``kind`` for ``cfg`` on ``device``:
    ``train(model, opt_state, batch)``, ``prefill(model, batch, cache)``
    or ``decode(model, tokens, cache)`` (which first sets ``cache["pos"]
    = pos``)."""
    if kind == "train":
        return make_train_step(cfg, _opt_config(cfg))
    mod = get_model(cfg)
    if kind == "prefill":
        def prefill(model, batch, cache):
            return mod.prefill(model, batch, cfg, cache, device=device)
        return prefill

    def decode(model, tokens, cache):
        cache["pos"] = pos
        return mod.decode_step(model, tokens, cache, cfg, device=device)
    return decode


def _real_inputs(batch, cfg: ModelConfig, gen, dev):
    out = {}
    for k, v in batch.items():
        if v.dtype.is_floating_point:
            out[k] = torch.randn(v.shape, generator=gen, device=dev,
                                 dtype=torch.float32).to(v.dtype)
        else:
            out[k] = torch.randint(0, cfg.vocab, v.shape, generator=gen,
                                   device=dev, dtype=v.dtype)
    return out


def build_cell(cfg: ModelConfig, shape: Shape, mesh,
               layer_unroll: int = 1, device="meta") -> Cell:
    """The cell of ``cfg`` at ``layer_unroll`` trips of depth (module
    docstring) for ``shape`` over ``mesh``, on ``device``: meta tensors by
    default; on a real device random weights, inputs and decode context
    from ``torch.Generator(device).manual_seed(0)``."""
    opt = _opt_config(cfg)        # by the full depth's parameter count
    cfg = _at_depth(cfg, layer_unroll).replace(layer_unroll=layer_unroll)
    dev = resolve_device(device)
    mod = get_model(cfg)
    gen = None if dev.type == "meta" else \
        torch.Generator(dev).manual_seed(0)
    batch = input_specs(cfg, shape)
    if gen is not None:
        batch = _real_inputs(batch, cfg, gen, dev)
    if cfg.act_shard == "full_dp" and shape.global_batch % mesh.size == 0:
        bspec = shd._filter_spec((shd.DP_AXES + (shd.TP_AXIS,),),
                                 tuple(mesh.axis_names))
        dp_div = mesh.size
    else:
        bspec = shd.batch_spec(mesh)
        dp_div = shd._dp_size(mesh)
    batch_specs = {k: bspec if v.shape[0] % dp_div == 0 else shd.P()
                   for k, v in batch.items()}
    batch_shards = dp_div if shape.global_batch % dp_div == 0 else 1
    model = mod.empty(cfg, dev) if gen is None else mod.init(cfg, gen, dev)
    param_specs = shd.param_shardings(model, mesh)

    if shape.kind == "train":
        opt_state = adamw_init(model, opt)
        opt_specs = {"m": param_specs, "v": param_specs, "step": shd.P()}
        return Cell(make_train_step(cfg, opt), (model, opt_state, batch),
                    (param_specs, opt_specs, batch_specs), "train", cfg,
                    shape, mesh, batch_shards)

    b = shape.global_batch
    # vlm prefill writes patch-prefix KV too; whisper/ssm caches ignore it
    extra = cfg.n_patches if cfg.family == "vlm" else 0
    cache = mod.init_cache(cfg, b, shape.seq_len + extra, device=dev)
    cache_specs = shd.cache_shardings(cache, mesh, b)
    if shape.kind == "prefill":
        return Cell(make_step(cfg, "prefill", dev), (model, batch, cache),
                    (param_specs, batch_specs, cache_specs), "prefill", cfg,
                    shape, mesh, batch_shards)

    if gen is not None:           # a random context before the new token
        for v in cache.values():
            if isinstance(v, torch.Tensor) and v.dtype.is_floating_point:
                for layer in v:      # one layer at a time: bounded f32 temp
                    layer.copy_(torch.randn(layer.shape, generator=gen,
                                            device=dev, dtype=torch.float32))
    pos = shape.seq_len + extra - 1
    return Cell(make_step(cfg, "decode", dev, pos),
                (model, batch["tokens"], cache),
                (param_specs, batch_specs["tokens"], cache_specs), "decode",
                cfg, shape, mesh, batch_shards)

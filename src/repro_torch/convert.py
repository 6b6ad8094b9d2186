"""Hand the JAX package's numpy outputs to the port.

The state carried across is data: features, codes, BDMs and catalogs,
numpy in both packages. :func:`to_device` makes a device tensor of the
dtype the port's kernels take (features float32 or bfloat16, catalog
tiles int32), contiguous; :func:`catalog_from` rebuilds a port
``TileCatalog`` from any object carrying a catalog's arrays and sizes
(the reference's ``TileCatalog`` included) without importing it.

For the resident ER service, :func:`service_config_from` copies a
reference ``ServiceConfig`` into the port's, mapping the kernel route's
names (``"xla"`` and ``"interpret"`` → ``"torch"``, ``"pallas"`` →
``"cuda"``); its ``feedback_state`` (``ERService.export_feedback_state()``,
plain JSON data) passes across as it is.

For the LM families, :func:`config_from` copies a reference
``ModelConfig`` (any object with its fields) into the port's, mapping the
attention route's names (``"xla"`` → ``"plain"``, ``"pallas"`` →
``"kernel"``), :func:`model_params_from` turns the reference's params
pytree, as numpy arrays, into the port's ``LanguageModel`` (every
family), and :func:`opt_state_from` turns the reference's AdamW state
into the port's, so a train step can continue from it.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .er.compiler.ir import NCOLS, TileCatalog
from .models.config import ModelConfig

__all__ = ["to_device", "catalog_from", "service_config_from",
           "config_from", "model_params_from", "opt_state_from"]

_KINDS = {"f": torch.float32, "i": torch.int32, "u": torch.uint8}


def to_device(array, device="cuda", dtype=None) -> torch.Tensor:
    """A contiguous tensor on ``device``: floats become float32 (or
    ``dtype``, e.g. ``torch.bfloat16``), signed integers int32 (the
    catalog and length layout), bytes stay uint8 (title codes)."""
    arr = np.asarray(array)
    if dtype is None:
        dtype = _KINDS[arr.dtype.kind]
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(resolve_device(device))
    return t.to(dtype).contiguous()


def catalog_from(cat) -> TileCatalog:
    """A port ``TileCatalog`` with ``cat``'s tiles (as int32) and sizes."""
    tiles = np.ascontiguousarray(np.asarray(cat.tiles, np.int32))
    if tiles.ndim != 2 or tiles.shape[1] != NCOLS:
        raise ValueError(f"catalog tiles must be (T, {NCOLS}), got "
                         f"{tiles.shape}")
    return TileCatalog(tiles=tiles, block_m=int(cat.block_m),
                       block_n=int(cat.block_n), n_rows_a=int(cat.n_rows_a),
                       n_rows_b=int(cat.n_rows_b), r=int(cat.r),
                       total_pairs=int(cat.total_pairs))


_KERNEL_IMPLS = {"xla": "torch", "interpret": "torch", "pallas": "cuda",
                 "auto": "auto"}


def service_config_from(cfg, **overrides):
    """The port's ``ServiceConfig`` with ``cfg``'s fields (a reference
    ``ServiceConfig`` or any object carrying them). ``kernel_impl`` maps
    "xla" / "interpret" → "torch", "pallas" → "cuda" and keeps "auto";
    ``feedback_state`` is passed as it is."""
    import dataclasses

    from .er.service import ServiceConfig

    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(
        ServiceConfig) if hasattr(cfg, f.name)}
    if "kernel_impl" in kw:
        impl = kw["kernel_impl"]
        if impl not in _KERNEL_IMPLS:
            raise ValueError(f"unknown kernel_impl {impl!r}")
        kw["kernel_impl"] = _KERNEL_IMPLS[impl]
    kw.update(overrides)
    return ServiceConfig(**kw)


_ATTN_NAMES = {"xla": "plain", "pallas": "kernel"}


def config_from(cfg, **overrides) -> ModelConfig:
    """The port's ``ModelConfig`` with ``cfg``'s fields (a reference
    ``ModelConfig`` or any object carrying them); the attention route's
    names map ``"xla"`` → ``"plain"`` and ``"pallas"`` → ``"kernel"``."""
    import dataclasses

    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(
        ModelConfig) if hasattr(cfg, f.name)}
    kw["attn_impl"] = _ATTN_NAMES.get(kw["attn_impl"], kw["attn_impl"])
    kw.update(overrides)
    return ModelConfig(**kw)


def _tensor(arr, dtype, device):
    if arr.dtype.kind == "V":     # ml_dtypes bfloat16: torch cannot wrap it
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device, dtype)  # a writable copy


def _named_arrays(tree, model) -> dict:
    """The arrays of a params-shaped ``tree`` (numpy leaves) by the port's
    parameter names. A subtree whose name is a stack of ``model`` (an
    ``nn.ModuleList``: ``layers``, zamba2's ``blocks``, whisper's
    ``enc_layers`` / ``dec_layers``) has stacked leaves: their leading axes
    (``(n,)``, or zamba2's ``(n_super, every)``) are flattened and
    unstacked into one node each. Raises if a name or shape does not
    match, or a parameter is missing."""
    params = dict(model.named_parameters())
    out = {}

    def put(prefix, sub, stack=None):
        for name, val in sub.items():
            path = f"{prefix}{name}"
            if isinstance(val, dict):
                put(path + ".", val, stack)
                continue
            arr = np.asarray(val)
            if stack is None:
                dst = params.get(path)
                if dst is None:
                    raise ValueError(f"{path}: no such parameter in the "
                                     "port")
                if tuple(arr.shape) != tuple(dst.shape):
                    raise ValueError(f"{path}: shape {arr.shape} != "
                                     f"{tuple(dst.shape)}")
                out[path] = arr
                continue
            stack_name, n = stack
            dst = params.get(f"{stack_name}.0.{path}")
            if dst is None:
                raise ValueError(f"{stack_name}.{path}: no such parameter in "
                                 "the port")
            lead = arr.shape[:arr.ndim - dst.dim()]
            if tuple(arr.shape[len(lead):]) != tuple(dst.shape) \
                    or int(np.prod(lead)) != n:
                raise ValueError(f"{stack_name}.{path}: shape {arr.shape} "
                                 f"is not {n} stacked {tuple(dst.shape)}")
            flat = arr.reshape((n,) + tuple(dst.shape))
            for i in range(n):
                out[f"{stack_name}.{i}.{path}"] = flat[i]

    for name, val in tree.items():
        node = getattr(model, name, None)
        if isinstance(node, torch.nn.ModuleList):
            put("", val, (name, len(node)))
        elif isinstance(val, dict):
            put(name + ".", val)
        else:
            put("", {name: val})
    if set(out) != set(params):
        raise ValueError(f"parameters not in the tree: "
                         f"{sorted(set(params) - set(out))}")
    return out


def model_params_from(tree, cfg: ModelConfig, device="cuda"):
    """The port's model with the reference's params: ``tree`` is the
    params pytree of ``repro.models`` as numpy arrays
    (``jax.tree.map(np.asarray, params)``), of any family. Layer-stacked
    subtrees are unstacked into one node per layer (zamba2's ``(n_super,
    every, …)`` ``blocks`` into ``n_layers`` nodes, in order); every array
    keeps its layout (the g-major column order of ``wq`` / ``wo``
    included). Raises if a name or shape does not match."""
    from .models import get_model

    model = get_model(cfg).empty(cfg, device)
    arrays = _named_arrays(tree, model)
    with torch.no_grad():
        for name, dst in model.named_parameters():
            dst.copy_(_tensor(arrays[name], dst.dtype, dst.device))
    return model


def _moment_dtype(arr) -> torch.dtype:
    return torch.bfloat16 if arr.dtype.name == "bfloat16" else torch.float32


def opt_state_from(tree, model):
    """The port's AdamW state (``repro_torch.train.optimizer``) from the
    reference's ``{"m", "v", "step"}`` (as numpy arrays): the moments by
    parameter name on ``model``'s device, in their dtype (float32, or
    bfloat16 for ``moment_dtype="bfloat16"``), and the step as a host
    int32 scalar."""
    dev = model.device
    state = {}
    for key in ("m", "v"):
        arrays = _named_arrays(tree[key], model)
        state[key] = {name: _tensor(arr, _moment_dtype(arr), dev)
                      for name, arr in arrays.items()}
    state["step"] = torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32)
    return state

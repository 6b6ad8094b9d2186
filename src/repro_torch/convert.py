"""Hand the JAX package's numpy outputs to the port.

The state carried across is data: features, codes, BDMs and catalogs,
numpy in both packages. :func:`to_device` makes a device tensor of the
dtype the port's kernels take (features float32 or bfloat16, catalog
tiles int32), contiguous; :func:`catalog_from` rebuilds a port
``TileCatalog`` from any object carrying a catalog's arrays and sizes
(the reference's ``TileCatalog`` included) without importing it.

For the LM families, :func:`config_from` copies a reference
``ModelConfig`` (any object with its fields) into the port's, mapping the
attention route's names (``"xla"`` → ``"plain"``, ``"pallas"`` →
``"kernel"``), and :func:`model_params_from` turns the reference's params
pytree, as numpy arrays, into the port's ``LanguageModel``.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .er.compiler.ir import NCOLS, TileCatalog
from .models.config import ModelConfig

__all__ = ["to_device", "catalog_from", "config_from", "model_params_from"]

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


def model_params_from(tree, cfg: ModelConfig, device="cuda"):
    """The port's model with the reference's params: ``tree`` is the
    params pytree of ``repro.models`` as numpy arrays
    (``jax.tree.map(np.asarray, params)``). The leading ``n_layers`` axis
    of ``tree["layers"]`` is unstacked into one node per layer; every
    array keeps its layout (the g-major column order of ``wq`` / ``wo``
    included). Raises if a name or shape does not match."""
    from .models import get_model

    model = get_model(cfg).empty(cfg, device)
    filled = set()

    def put(node, prefix, sub, index=None):
        for name, val in sub.items():
            path = f"{prefix}{name}"
            if isinstance(val, dict):
                put(getattr(node, name), path + ".", val, index)
                continue
            dst = getattr(node, name, None)
            if dst is None:
                raise ValueError(f"{path}: no such parameter in the port")
            arr = np.asarray(val) if index is None else np.asarray(val)[index]
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{path}: shape {arr.shape} != "
                                 f"{tuple(dst.shape)}")
            with torch.no_grad():
                dst.copy_(_tensor(arr, dst.dtype, dst.device))
            filled.add(path if index is None else f"layers.{index}.{path}")

    put(model, "", {k: v for k, v in tree.items() if k != "layers"})
    for i, node in enumerate(model.layers):
        put(node, "", tree["layers"], index=i)
    want = {n for n, _ in model.named_parameters()}
    if filled != want:
        raise ValueError(f"parameters not in the tree: "
                         f"{sorted(want - filled)}")
    return model

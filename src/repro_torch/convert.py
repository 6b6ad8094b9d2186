"""Hand the JAX package's numpy outputs to the port.

The state carried across is data: features, codes, BDMs and catalogs,
numpy in both packages. :func:`to_device` makes a device tensor of the
dtype the port's kernels take (features float32 or bfloat16, catalog
tiles int32), contiguous; :func:`catalog_from` rebuilds a port
``TileCatalog`` from any object carrying a catalog's arrays and sizes
(the reference's ``TileCatalog`` included) without importing it.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .er.compiler.ir import NCOLS, TileCatalog

__all__ = ["to_device", "catalog_from"]

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

"""The ER executor's device mesh and its collectives, driven by one process.

Port of ``repro.sharding.make_er_mesh`` (the model-side partition specs
of the training substrate come with the training port). The reference
is single-controller: one Python process plans and drives ``shard_map``
over a ``jax.sharding.Mesh``. The port keeps that shape with no
``torch.distributed`` at all:

  * a :class:`Mesh` is a ``(n_data, n_model)`` grid of ``torch.device``,
    row-major with ``model`` fastest, as the reference reshapes it — one
    device per position, or one device repeated (logical shards, the
    counterpart of the reference tests' simulated host devices);
  * a :class:`Sharded` matrix is the grid of its per-position tensors
    (:func:`shard_rows` row-shards over ``data`` and column-shards over
    ``model``; :func:`replicate` copies the rows to every ``data``
    position);
  * a collective is an explicit tensor move between the positions'
    devices, ``Tensor.to(device, non_blocking=True)``: a peer copy
    between two GPUs, nothing at all between two logical shards of one
    device (the result then aliases its source, which the executor only
    reads).

``all_gather`` and ``ppermute`` take an optional ``traffic`` list (one
int per position) and add the bytes a position receives from ANOTHER
position, whether or not they cross a wire — the quantity the comms
formulas of ``er/compiler/comms.py`` account.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "Sharded", "make_er_mesh", "shard_rows", "replicate",
           "all_gather", "ppermute", "psum", "axis_index", "TP_AXIS"]

TP_AXIS = "model"


class Mesh:
    """A 2-D grid of torch devices with named axes.

    ``devices`` is the ``(n_axis0, n_axis1)`` object array of
    ``torch.device``; ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does. Every device of a mesh has one type
    (all CUDA or all CPU)."""

    def __init__(self, devices, axis_names: Sequence[str] = ("data",
                                                             TP_AXIS)):
        shape = np.shape(devices)
        if len(shape) != 2 or len(axis_names) != 2 or 0 in shape:
            raise ValueError("a mesh is a non-empty 2-D device grid with "
                             "two axis names")
        grid = np.empty(shape, object)
        for i, j in np.ndindex(shape):
            grid[i, j] = torch.device(devices[i][j])
        types = {d.type for d in grid.flat}
        if len(types) != 1 or types - {"cuda", "cpu"}:
            raise ValueError(f"mesh devices must all be CUDA or all CPU "
                             f"(got {sorted(types)})")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    @property
    def first_device(self) -> torch.device:
        """Position (0, 0): where the host-side stages (verifier, legacy
        results) run."""
        return self.devices.flat[0]

    def grid(self, axis: str = "data",
             model_axis: Optional[str] = None) -> np.ndarray:
        """The ``(n_data, n_model)`` device grid of a data flow that shards
        rows over ``axis`` and columns over ``model_axis``. Without a
        model axis every data position uses its first model column (the
        other columns would repeat its work)."""
        if axis not in self.axis_names:
            raise ValueError(f"unknown mesh axis {axis!r}")
        grid = (self.devices if self.axis_names.index(axis) == 0
                else self.devices.T)
        if model_axis is None:
            return grid[:, :1]
        if model_axis == axis or model_axis not in self.axis_names:
            raise ValueError(f"model_axis {model_axis!r} must be the "
                             f"mesh's other axis")
        return grid


def make_er_mesh(n_data: int, n_model: int = 1, *,
                 devices: Optional[Sequence] = None) -> Mesh:
    """The ER executor's 2-D ``(data, model)`` mesh: corpus rows shard
    over ``data``, the hashed n-gram feature dimension over ``model``
    (``compiler.execute(model_axis="model")`` psums the partial tile
    scores). Devices fill the grid row-major, ``model`` fastest, so a
    model group's devices are adjacent.

    By default the first ``n_data·n_model`` CUDA devices; raises
    ``ValueError`` when there are fewer (nothing falls back to the CPU).
    ``devices=`` lists them explicitly and may repeat one device:
    ``["cpu"] * 8`` gives 8 logical CPU shards, ``["cuda:0"] * 8`` 8
    logical shards of one card."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    need = n_data * n_model
    if n_data < 1 or n_model < 1 or len(devices) < need:
        raise ValueError(f"need {need} devices for a ({n_data}, {n_model}) "
                         f"mesh, have {len(devices)}")
    grid = [devices[i * n_model:(i + 1) * n_model] for i in range(n_data)]
    return Mesh(grid, ("data", TP_AXIS))


@dataclass(frozen=True)
class Sharded:
    """A matrix laid out over a device grid: ``blocks[d][m]`` lies on the
    grid's device (d, m) and holds row block d (all rows when
    ``row_split`` is false — replicated over ``data``) and column block
    m. ``shape`` is the global (rows, cols)."""
    blocks: Tuple[Tuple[torch.Tensor, ...], ...]
    shape: Tuple[int, int]
    row_split: bool

    def column(self, m: int) -> List[torch.Tensor]:
        """The blocks of column block ``m``, one per data position."""
        return [row[m] for row in self.blocks]


def _to_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _layout(x, grid: np.ndarray, row_split: bool) -> Sharded:
    t = _to_tensor(x)
    n_data, n_model = grid.shape
    rows, cols = int(t.shape[0]), int(t.shape[1])
    if row_split and rows % n_data:
        raise ValueError(f"{rows} rows do not shard over {n_data} data "
                         f"positions")
    if cols % n_model:
        raise ValueError(f"{cols} columns do not shard over {n_model} "
                         f"model positions")
    nl = rows // n_data if row_split else rows
    dl = cols // n_model
    blocks = []
    for d in range(n_data):
        r0 = d * nl if row_split else 0
        blocks.append(tuple(
            t[r0:r0 + nl, m * dl:(m + 1) * dl].to(
                grid[d, m], non_blocking=True).contiguous()
            for m in range(n_model)))
    return Sharded(blocks=tuple(blocks), shape=(rows, cols),
                   row_split=row_split)


def shard_rows(x, grid: np.ndarray) -> Sharded:
    """Row-shard ``x`` (numpy or a tensor, rows divisible by n_data,
    columns by n_model) over an ``(n_data, n_model)`` device grid."""
    return _layout(x, grid, row_split=True)


def replicate(x, grid: np.ndarray) -> Sharded:
    """Every data position holds all rows of ``x``; columns shard over
    the model positions."""
    return _layout(x, grid, row_split=False)


def _received(traffic: Optional[List[int]], pos: int, nbytes: int) -> None:
    if traffic is not None:
        traffic[pos] += int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather(shards: Sequence[torch.Tensor], devices: Sequence,
               traffic: Optional[List[int]] = None) -> List[torch.Tensor]:
    """Tiled all-gather: position i gets every shard, concatenated along
    rows in position order, on ``devices[i]``."""
    out = []
    for i, dev in enumerate(devices):
        out.append(torch.cat([s.to(dev, non_blocking=True) for s in shards],
                             dim=0))
        _received(traffic, i, sum(_nbytes(s) for j, s in enumerate(shards)
                                  if j != i))
    return out


def ppermute(shards: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]],
             devices: Sequence,
             traffic: Optional[List[int]] = None) -> List[torch.Tensor]:
    """Send ``shards[src]`` to position ``dst`` for each ``(src, dst)`` of
    ``perm``; a position that receives nothing gets zeros, as
    ``jax.lax.ppermute`` gives it."""
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for src, dst in perm:
        out[dst] = shards[src].to(devices[dst], non_blocking=True)
        if src != dst:
            _received(traffic, dst, _nbytes(shards[src]))
    return [torch.zeros_like(shards[i]) if t is None else t
            for i, t in enumerate(out)]


def psum(shards: Sequence[torch.Tensor],
         devices: Sequence) -> List[torch.Tensor]:
    """All-reduce sum: every position gets the sum of all shards, added in
    position order on ``devices[0]`` and copied back (a reduce and a
    broadcast; the executor's ``psum_bytes`` counter keeps the
    reference's ring all-reduce accounting)."""
    total = shards[0].to(devices[0], non_blocking=True)
    for s in shards[1:]:
        total = total + s.to(devices[0], non_blocking=True)
    return [total] + [total.to(dev, non_blocking=True)
                      for dev in devices[1:]]


def axis_index(mesh: Mesh, axis: str) -> np.ndarray:
    """Each mesh position's coordinate along ``axis``, shaped like
    ``mesh.devices`` (``jax.lax.axis_index`` evaluated at every
    position)."""
    return np.indices(mesh.devices.shape)[mesh.axis_names.index(axis)]

"""Production and test meshes of the cell harness.

Single pod: 16×16 = 256 GPUs, axes (data, model).
Multi-pod:  2×16×16 = 512 GPUs, axes (pod, data, model) — the ``pod``
axis carries only data parallelism.

These are the reference's shapes (``repro.launch.mesh``), read as H100s.
The production meshes are abstract (``sharding.AbstractMesh``: names and
sizes, no devices): the dry-run counts a cell's per-device cost from its
specs and runs nothing across them. ``make_test_mesh`` is a real mesh
of the ER layer (``sharding.Mesh``) over the devices that exist.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..sharding import AbstractMesh, Mesh, make_er_mesh

__all__ = ["make_production_mesh", "make_test_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_test_mesh(n_data: Optional[int] = None, n_model: int = 1,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A small ``(data, model)`` mesh over ``devices``: every CUDA card by
    default (raises without one; nothing falls back to the CPU), or the
    devices given, e.g. ``["cpu"] * 4``. ``n_data`` defaults to
    ``len(devices) // n_model``."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("no CUDA device for the test mesh; pass "
                               "devices=['cpu'] * n to build one on the CPU")
        devices = [torch.device("cuda", i) for i in range(count)]
    n_data = n_data or (len(devices) // n_model)
    return make_er_mesh(n_data, n_model, devices=devices)

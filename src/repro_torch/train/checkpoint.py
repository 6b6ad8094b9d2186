"""Step-sharded checkpointing with elastic restore, in PyTorch.

Port of ``repro.train.checkpoint``, with its layout:

    <dir>/step_<N>/
        manifest.json       — step, shard count, and per leaf its path,
                              shape, dtype and shard
        shard_<i>.npz       — the leaves, round-robin over the shards

A tree is a nested dict (string keys) whose leaves are tensors, numpy
arrays or numbers: the train launcher saves ``{"params": {name: tensor},
"opt": {"m": {…}, "v": {…}, "step": …}}``, parameters by their
``state_dict`` names. The reference serialises a JAX treedef into the
manifest; the port names each leaf by its key path (a list of keys, so
names holding dots stay whole) instead.

  * every leaf is saved whole, from the host, so a restore works on any
    device: a checkpoint saved on the card restores on the CPU;
  * bf16 leaves are stored as their bits (``uint16``, dtype "bfloat16" in
    the manifest; numpy has no bf16) and round-trip exactly;
  * writes are atomic (a ``.tmp`` directory, then a rename), so a killed
    run never leaves half a checkpoint;
  * ``async_save`` copies the tree to the host on the caller's thread
    (a copy, so that in-place updates of the next steps cannot reach it)
    and writes on a background thread, one write in flight.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["save", "restore", "latest_step", "async_save"]


def _leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, val in tree.items():
        if not isinstance(key, str):
            raise TypeError(f"checkpoint keys must be strings, got {key!r}")
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _host_copy(leaf) -> torch.Tensor:
    """A CPU tensor that shares no memory with ``leaf``."""
    return torch.as_tensor(leaf).detach().to("cpu", copy=True)


def _host_tree(tree):
    return {k: _host_tree(v) if isinstance(v, dict) else _host_copy(v)
            for k, v in tree.items()}


def _encode(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array stored, the dtype named in the manifest)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _decode(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    t = torch.from_numpy(np.array(arr))
    if str(t.dtype).removeprefix("torch.") != dtype:
        raise ValueError(f"leaf stored as {arr.dtype}, manifest says "
                         f"{dtype}")
    return t


def save(path: str, tree: Any, step: int, num_shards: int = 4) -> str:
    """Write ``tree`` as ``<path>/step_<step>`` (atomically). Returns the
    directory."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    shards: Dict[int, Dict[str, np.ndarray]] = {i: {} for i in
                                                range(num_shards)}
    meta: List[dict] = []
    for i, (keys, leaf) in enumerate(_leaves(tree)):
        arr, dtype = _encode(torch.as_tensor(leaf))
        shards[i % num_shards][f"leaf_{i}"] = arr
        meta.append({"index": i, "shard": i % num_shards, "path": list(keys),
                     "shape": list(arr.shape), "dtype": dtype})
    for s, data in shards.items():
        np.savez(os.path.join(tmp, f"shard_{s}.npz"), **data)
    manifest = {"step": step, "num_shards": num_shards, "leaves": meta}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(path: str, step: Optional[int] = None,
            device="cuda") -> Tuple[Any, int]:
    """Returns (the tree, step): the latest step unless ``step`` is given,
    every leaf a tensor on ``device``."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    shard_data = {}
    for s in range(manifest["num_shards"]):
        with np.load(os.path.join(d, f"shard_{s}.npz")) as z:
            shard_data.update({k: z[k] for k in z.files})
    tree: Dict[str, Any] = {}
    for m in manifest["leaves"]:
        t = _decode(shard_data[f"leaf_{m['index']}"], m["dtype"])
        if list(t.shape) != m["shape"]:
            raise ValueError(f"{m['path']}: shape {list(t.shape)} != "
                             f"{m['shape']}")
        node = tree
        for key in m["path"][:-1]:
            node = node.setdefault(key, {})
        node[m["path"][-1]] = t.to(dev)
    return tree, step


class async_save:
    """Background-thread checkpoint writer with a single in-flight slot:
    the host copy happens on the caller's thread, the disk write overlaps
    the next training steps. A write that failed raises from the next
    ``wait`` (or the next call, which waits first)."""

    def __init__(self, path: str, num_shards: int = 4):
        self.path = path
        self.num_shards = num_shards
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _write(self, tree, step):
        try:
            save(self.path, tree, step, self.num_shards)
        except BaseException as e:  # handed to the caller by wait()
            self._error = e

    def __call__(self, tree: Any, step: int):
        host_tree = _host_tree(tree)       # sync host copy
        self.wait()
        self._thread = threading.Thread(target=self._write,
                                        args=(host_tree, step), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

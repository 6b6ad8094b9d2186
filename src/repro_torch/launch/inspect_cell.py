"""Microscope: count one cell and attribute its memory and traffic.

    PYTHONPATH=src python -m repro_torch.launch.inspect_cell --arch rwkv6-7b \\
        --shape train_4k [--layers 2] [--act-shard d] [--unroll 1] [--top 12]

Port of ``repro.launch.inspect_cell``. Prints four sections: the largest
per-device argument shards with their specs (catches unsharded params),
the counted totals and peak live bytes, the largest tensors the step
creates (dtype[shape] × count, the counterpart of the reference's top
HLO buffers) and the collective breakdown. The cell is built on meta
tensors over the 16x16 production mesh at ``--unroll`` trips of depth
(``steps.build_cell``); ``--layers`` sets the config's depth first.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

__all__ = ["main"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", default="train_4k")
    p.add_argument("--layers", type=int, default=0, help="override n_layers")
    p.add_argument("--act-shard", default=None)
    p.add_argument("--unroll", type=int, default=1)
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)

    from .. import sharding as shd
    from ..configs import ARCHS, SHAPES
    from .mesh import make_production_mesh
    from .roofline import analyze_cell
    from .steps import build_cell

    cfg = ARCHS[args.arch]
    if args.layers:
        kw = {"n_layers": args.layers}
        if cfg.family == "hybrid":
            kw["n_layers"] = max(args.layers // cfg.shared_attn_every, 1) \
                * cfg.shared_attn_every
        if cfg.family == "audio":
            kw["n_encoder_layers"] = args.layers
        cfg = cfg.replace(**kw)
    if args.act_shard:
        cfg = cfg.replace(act_shard=args.act_shard)
    shape = SHAPES[args.shape]
    mesh = make_production_mesh()
    cell = build_cell(cfg, shape, mesh, layer_unroll=args.unroll)

    print("== largest per-device argument shards ==")
    entries = []
    names = ("params", "opt_state", "batch") if cell.kind == "train" else (
        ("params", "batch", "cache") if cell.kind == "prefill"
        else ("params", "tokens", "cache"))
    for arg_name, arg, specs in zip(names, cell.args, cell.in_specs):
        if isinstance(arg, torch.nn.Module):
            arg = dict(arg.named_parameters())
        for path, t, spec in _named(arg, specs, arg_name):
            total = t.numel() * t.element_size()
            per_dev = int(np.prod(shd.shard_shape(t.shape, spec, mesh))) \
                * t.element_size()
            entries.append((per_dev, total, path, spec))
    entries.sort(key=lambda e: (-e[0], e[2]))
    for per_dev, total, path, spec in entries[: args.top]:
        print(f"  {per_dev / 2**20:10.1f} MiB/dev (total {total / 2**30:6.2f} "
              f"GiB) {path}  spec={spec}")

    with shd.set_mesh(mesh):    # the reference compiles under jax.set_mesh
        report, count = analyze_cell(cell, "16x16")
    print(f"\n== counted ==  ops={count.ops}  "
          f"peak live={count.peak_bytes / mesh.size / 2**30:.2f} GiB/dev  "
          f"args={report.argument_bytes / 2**30:.2f} GiB/dev  "
          f"flops/dev={report.flops_per_device:.3e}  "
          f"bytes/dev={report.bytes_per_device:.3e}")

    print("\n== largest tensors created ==")
    top = sorted(count.buffers.items(), key=lambda kv: (-kv[1][0], kv[0]))
    for (dtype, dims), (nbytes, n) in top[: args.top]:
        print(f"  {nbytes / 2**20:10.1f} MiB  ×{n:3d}  "
              f"{dtype}[{','.join(map(str, dims))}]")

    print("\n== collectives ==")
    print("  ", report.coll)
    return 0


def _named(arg, specs, path):
    """(path, tensor, spec) for every tensor of one argument (a tensor, or
    nested dicts of tensors beside the same keys of ``specs``)."""
    if isinstance(arg, torch.Tensor):
        return [(path, arg, specs)]
    if isinstance(arg, dict):
        return [item for k, v in arg.items()
                for item in _named(v, specs[k], f"{path}.{k}")]
    return []


if __name__ == "__main__":
    raise SystemExit(main())

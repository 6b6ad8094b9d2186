"""What every torch leg of the benchmarks shares: the device, the kernel
route that goes with it, and the command line.

Each ``benchmarks/torch_<name>.py`` runs its JAX leg's workload on the
PyTorch port (``src/repro_torch``) and keeps that leg's columns and row
order; it writes ``benchmarks/out/torch_<name>.json``. A leg is split in
two: ``measure(...) -> rows`` runs the workload (and asserts what is
exact), ``check(rows)`` holds the rows to the leg's wall-time bars;
``run()`` is the two in turn.

    PYTHONPATH=src python -m benchmarks.torch_<name> [--quick] [--device cpu|cuda]

``--device`` defaults to the card and raises without one: ``cpu`` runs
the kernels' plain PyTorch versions, and nothing falls back to them by
itself. On the card every kernel runs on the ``cuda`` route, which
raises if the kernel does not build or launch.
"""
from __future__ import annotations

import argparse

import torch


def impl_of(dev: torch.device) -> str:
    """The kernel route a leg asks for on ``dev``: the CUDA kernel on the
    card, the plain version on the CPU."""
    return "cuda" if dev.type == "cuda" else "torch"


def cli(run, doc: str, argv=None, **extra) -> int:
    """Parse ``--quick`` and ``--device`` (plus ``extra`` int options,
    name -> default) and call ``run(quick=, device=, **extra)``."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--quick", action="store_true",
                   help="reduced sizes, the JAX leg's --smoke")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the card (default) or the plain versions on the CPU")
    for name, default in extra.items():
        p.add_argument(f"--{name.replace('_', '-')}", type=int,
                       default=default)
    args = p.parse_args(argv)
    kw = {name: getattr(args, name) for name in extra}
    run(quick=args.quick, device=args.device, **kw)
    return 0


def count_view(rows, counts, order=None):
    """``rows`` cut to the ``counts`` columns (a missing column reads as
    None), in row order or sorted by the ``order`` column: what a torch
    leg's rows must share with its JAX leg's, or with its own on another
    device."""
    view = [{c: row.get(c) for c in counts} for row in rows]
    if order is not None:
        view.sort(key=lambda row: str(row[order]))
    return view

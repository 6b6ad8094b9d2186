"""Dry-run: count every (architecture × input shape) cell on the
production meshes and report its roofline terms with H100 constants.

    PYTHONPATH=src python -m repro_torch.launch.dryrun                # all cells, 16x16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod    # 2x16x16, 512 GPUs
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k -v

Port of ``repro.launch.dryrun``. Writes JSON rows to ``--out`` (default
``benchmarks/out/torch_dryrun_<mesh>.json``), merged into the rows an
existing file holds; exits 1 when any cell fails. Nothing is compiled
and no device memory is allocated: each cell is built on meta tensors
(``steps.build_cell``) and its eager dispatch counted
(``roofline.count_cost``) at 1 and 2 trips of depth, then extrapolated
to the full depth, inside ``sharding.set_mesh(mesh)`` as the reference
lowers inside ``jax.set_mesh`` (the sharding hooks record; no count
moves). ``count_s`` (the reference's ``compile_s``) is the seconds of
counting.

A train or prefill cell of a family with a time loop (ssm, hybrid)
dispatches every time step, ~8 ops a step and layer: one trip of
zamba2-2.7b at 32,768 steps is ~1.6M meta ops, minutes on a CPU, and its
two points take three trips' time. They still count trips 1 and 2: a
zero-trip cell is no point on the same line (zamba2's shared block goes
unused, so its gradients are neither made nor accumulated, and the peak
of live bytes falls elsewhere). ``--no-extrapolate`` counts one trip and
reports it as it is, as the reference's single u=1 compile.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

__all__ = ["run_cell", "main"]


def _count(cfg, shape, mesh, mesh_name, trips):
    from ..sharding import set_mesh
    from .roofline import analyze_cell
    from .steps import build_cell

    t0 = time.perf_counter()
    cell = build_cell(cfg, shape, mesh, layer_unroll=trips)
    with set_mesh(mesh):    # the reference lowers under jax.set_mesh
        report, count = analyze_cell(cell, mesh_name)
    return report, count, time.perf_counter() - t0


def run_cell(cfg, shape, mesh, mesh_name, verbose=False, extrapolate=True):
    """Count the cell at one trip of depth and, when ``extrapolate``, at
    two, and extrapolate to ``scan_trips(cfg)``:
    ``true = c1 + (trips−1)·(c2−c1)``. Returns the row."""
    from .roofline import extrapolate_report, model_flops
    from .steps import scan_trips

    trips = scan_trips(cfg)
    grows = shape.kind == "train"
    rep, count, secs = _count(cfg, shape, mesh, mesh_name, 1)
    how = "none"
    if extrapolate and trips > 1:
        rep2, _, s2 = _count(cfg, shape, mesh, mesh_name, 2)
        rep = extrapolate_report(rep, rep2, trips, temp_grows=grows)
        how, secs = "trips 1,2", secs + s2
    # the cell's MODEL_FLOPS are of its depth: the useful work is the
    # full config's
    rep.model_flops_total = model_flops(cfg, shape)
    row = rep.row()
    row.update({"count_s": round(secs, 1), "status": "ok",
                "temp_bytes_gib": round(rep.temp_bytes / 2**30, 2),
                "arg_bytes_gib": round(rep.argument_bytes / 2**30, 2)})
    print(f"  counted {how if how != 'none' else 'one trip'}", flush=True)
    if verbose:
        print(f"  u=1: {count.ops} ops, peak live "
              f"{count.peak_bytes / 2**30:.2f} GiB (all devices)")
        print(f"  extrapolated flops/dev={row['flops/dev']:.3e} "
              f"bytes/dev={row['bytes/dev']:.3e}")
        print(f"  collectives: {rep.coll}")
    return row


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None, help="single arch id (default: all)")
    p.add_argument("--shape", default=None, help="single shape (default: all)")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--no-extrapolate", action="store_true",
                   help="count one trip of depth per cell and report it "
                        "as it is (the multi-pod pass only proves the pod "
                        "axis shards; the roofline table is single-pod)")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    from ..configs import ARCHS, SHAPES, skip_reason
    from .mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)

    rows, failures = [], []
    for a in archs:
        cfg = ARCHS[a]
        for s in shapes:
            shape = SHAPES[s]
            reason = skip_reason(cfg, shape)
            tag = f"{a} × {s} × {mesh_name}"
            if reason:
                print(f"[skip] {tag}: {reason}")
                rows.append({"arch": a, "shape": s, "mesh": mesh_name,
                             "status": "skip", "reason": reason})
                continue
            print(f"[cell] {tag} ...", flush=True)
            try:
                row = run_cell(cfg, shape, mesh, mesh_name, args.verbose,
                               extrapolate=not args.no_extrapolate)
                rows.append(row)
                print(f"  ok: count {row['count_s']}s "
                      f"bottleneck={row['bottleneck']} step={row['step_s']:.4f}s "
                      f"mfu={row['mfu']:.3f} "
                      f"temp={row['temp_bytes_gib']}GiB", flush=True)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append(tag)
                rows.append({"arch": a, "shape": s, "mesh": mesh_name,
                             "status": "fail", "error": str(e)[:500]})
                print(f"  FAIL: {e}", flush=True)
                if args.verbose:
                    traceback.print_exc()

    out = args.out or f"benchmarks/out/torch_dryrun_{mesh_name}.json"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    # merge into existing rows (single-cell reruns update their cell only)
    merged = {}
    if os.path.exists(out):
        try:
            with open(out) as f:
                for r in json.load(f):
                    merged[(r.get("arch"), r.get("shape"), r.get("mesh"))] = r
        except (json.JSONDecodeError, OSError):
            pass
    for r in rows:
        merged[(r.get("arch"), r.get("shape"), r.get("mesh"))] = r
    rows_out = list(merged.values())
    with open(out, "w") as f:
        json.dump(rows_out, f, indent=1)
    print(f"\nwrote {len(rows)} rows ({len(rows_out)} total) to {out}")
    if failures:
        print(f"FAILED cells: {failures}")
        return 1
    print("all cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())

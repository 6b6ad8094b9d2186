"""Run every torch leg of the benchmarks on the port (torch counterpart of
``run``):

    PYTHONPATH=src python -m benchmarks.torch_run [--quick] [--only fig8,fig12,...] [--device cpu|cuda]

One leg per paper table or figure (Fig. 8–14), the kernel, serving,
scheduling, supervisor, tuning and mesh benches, under the JAX runner's
suite names. ``--device`` defaults to the card and raises without one;
``cpu`` runs the kernels' plain versions. The dry-run / roofline tables
are produced separately by ``python -m repro_torch.launch.dryrun`` (a
count on meta tensors that runs for minutes); their latest outputs,
``benchmarks/out/torch_dryrun_{16x16,2x16x16}.json``, are summarized here
if present (``benchmarks.torch_roofline_table`` renders them).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

SUITES = ("fig8", "fig9", "fig10", "fig11", "fig12", "fig13", "sn_window",
          "kernels", "schedule", "serve", "mesh", "chaos", "steal", "tune")


def _legs():
    """Suite name -> the torch legs' ``run`` functions, in the JAX
    runner's order (``kernels`` runs both halves of the kernel leg)."""
    from . import (torch_chaos_bench, torch_fig8_datasets, torch_fig9_skew,
                   torch_fig10_reduce_tasks, torch_fig11_sorted,
                   torch_fig12_map_output, torch_fig13_scaling,
                   torch_fig_sn_window, torch_kernel_bench, torch_mesh_bench,
                   torch_schedule_bench, torch_serve_bench, torch_steal_bench,
                   torch_tune_bench)

    return dict(zip(SUITES, (
        torch_fig8_datasets.run, torch_fig9_skew.run,
        torch_fig10_reduce_tasks.run, torch_fig11_sorted.run,
        torch_fig12_map_output.run, torch_fig13_scaling.run,
        torch_fig_sn_window.run, torch_kernel_bench._main,
        torch_schedule_bench.run, torch_serve_bench.run,
        torch_mesh_bench.run, torch_chaos_bench.run, torch_steal_bench.run,
        torch_tune_bench.run)))


def dryrun_summary(out_dir=None) -> list:
    """One line per dry-run table present: ok / skip / fail counts."""
    out_dir = out_dir or os.path.join(os.path.dirname(__file__), "out")
    lines = []
    for mesh in ("16x16", "2x16x16"):
        path = os.path.join(out_dir, f"torch_dryrun_{mesh}.json")
        if os.path.exists(path):
            with open(path) as f:
                rows = json.load(f)
            n = {s: sum(1 for r in rows if r.get("status") == s)
                 for s in ("ok", "skip", "fail")}
            lines.append(f"dry-run {mesh}: {n['ok']} ok / {n['skip']} skip "
                         f"/ {n['fail']} fail ({path})")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("--quick", action="store_true",
                   help="reduced dataset sizes (the JAX legs' --smoke)")
    p.add_argument("--only", default=None,
                   help="comma-separated subset of " + ",".join(SUITES))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the card (default) or the plain versions on the CPU")
    args = p.parse_args(argv)
    only = set(args.only.split(",")) if args.only else set(SUITES)
    unknown = only - set(SUITES)
    if unknown:
        p.error(f"unknown suites {sorted(unknown)}")
    t0 = time.time()
    for name, fn in _legs().items():
        if name not in only:
            continue
        print(f"\n######## {name} ########", flush=True)
        fn(quick=args.quick, device=args.device)
    for line in dryrun_summary():
        print("\n" + line)
    print(f"\ntotal bench time on {args.device}: {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Render the roofline markdown table from the port's dry-run JSON (torch
leg of ``roofline_table``):

    PYTHONPATH=src python -m benchmarks.torch_roofline_table [--mesh 16x16] [--path FILE]

The rows are those ``python -m repro_torch.launch.dryrun`` writes to
``benchmarks/out/torch_dryrun_<mesh>.json`` (``RooflineReport.row()``
plus ``status``, ``temp_bytes_gib``; ``skip`` and ``fail`` rows carry
only arch, shape and why). The terms are priced with the port's H100
constants (``repro_torch.launch.roofline``): they are predictions from a
count on meta tensors, not measurements.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS


def _fmt_s(v):
    if v is None:
        return "-"
    if v >= 1:
        return f"{v:.2f}s"
    return f"{v * 1e3:.1f}ms"


def render(mesh: str = "16x16", path=None) -> str:
    """The markdown table of ``path`` (default: the dry-run's output for
    ``mesh``), rows sorted by arch and shape."""
    path = path or os.path.join(os.path.dirname(__file__), "out",
                                f"torch_dryrun_{mesh}.json")
    with open(path) as f:
        rows = json.load(f)
    rows.sort(key=lambda r: (r.get("arch", ""), r.get("shape", "")))
    chips = rows[0].get("chips", "?") if rows else "?"
    out = [
        f"### Roofline — mesh {mesh} ({chips} H100s; predicted with "
        f"{PEAK_FLOPS / 1e12:g} TFLOP/s dense bf16, {HBM_BW / 1e12:g} TB/s "
        f"HBM3, {LINK_BW / 1e9:g} GB/s a link)",
        "",
        "| arch | shape | compute | memory | collective | bottleneck | "
        "step | useful-FLOPs | MFU | temp GiB |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("status") == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"skipped | — | — | — | — |")
            continue
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"FAIL | — | — | — | — |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(r['compute_s'])} | "
            f"{_fmt_s(r['memory_s'])} | {_fmt_s(r['collective_s'])} | "
            f"{r['bottleneck']} | {_fmt_s(r['step_s'])} | "
            f"{r['useful_flops_frac']:.2f} | {r['mfu']:.3f} | "
            f"{r.get('temp_bytes_gib', 0):.1f} |")
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("--mesh", default="16x16")
    p.add_argument("--path", default=None,
                   help="a dry-run JSON (default: the --mesh table's)")
    args = p.parse_args(argv)
    print(render(args.mesh, args.path))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

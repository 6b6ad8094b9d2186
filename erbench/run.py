"""Run one cell of the benchmark once and print its result.

    python3 erbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. The last
line of standard output is the result (JSON); the numbers compared with
the reference, each beside its limit, are the last lines of standard
error. Exits non-zero, printing no result, without a card, or if JAX or
the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# Fixed directories inside the checkout for every build and kernel cache,
# so that only the first run of a checkout builds.
CACHES = {"REPRO_TORCH_BUILD_DIR": "erbench/.cache/kernels",
          "TRITON_CACHE_DIR": "erbench/.cache/triton"}


def forbidden_modules(names=None) -> list:
    """Modules (default: those loaded) whose top-level name is JAX's or
    the JAX package's, compared whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from erbench.harness import Layout, make_cell, run_cell

    cell = make_cell(Layout(ROOT), args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("erbench: no CUDA card; nothing measured", file=sys.stderr)
        return 2
    out = run_cell(cell, T_START, Layout(ROOT))
    bad = forbidden_modules()
    if bad:
        print(f"erbench: loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for name, v in out["check"].items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

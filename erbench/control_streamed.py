"""The control of the cells checked by the streamed reference: the
streamed reference put in the program's place with stage 1 in TF32, the
precision below the configuration's float32. It has to come out not
correct against the cell's limits.

    python3 erbench/control_streamed.py --workload <cell> --seeds 11 12 13

For each seed it scores the cell's whole corpus twice (float64, the
reference, and TF32, the control) and prints one JSON line with the
numbers, the limits, the seconds and the process's peak resident memory
so far. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(cell):
    """(numbers, limits) of the TF32 control for a ``batch_streamed``
    ``cell``."""
    from erbench.data import make_corpus
    from erbench.drivers.batch_streamed import window_numbers
    from erbench.reference import streamed

    corpus = make_corpus(cell.config["data"], cell.seed)
    er = dict(cell.config["run_er"], **cell.traffic.get("run_er", {}))
    strategy = er.get("strategy", "pair_range")
    want = streamed.batch_expected(corpus.titles, er, strategy, cell.device)
    ctl = streamed.batch_expected(corpus.titles, er, strategy, cell.device,
                                  "tf32")
    run = {"survivor_keys": ctl["survivors"], "matches": ctl["matches"]}
    return window_numbers([run], want, cell.device), cell.limits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    from erbench import check
    from erbench.harness import Layout, make_cell

    layout = Layout(ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = make_cell(layout, args.workload, seed, 0, False, args.device)
        numbers, limits = control_numbers(cell)
        correct, compared = check.verdict(numbers, limits)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": correct, "check": compared,
                          "seconds": time.perf_counter() - t0,
                          "peak_rss_gib": rss / 2 ** 20}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

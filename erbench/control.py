"""The control of the comparison: the reference put in the program's place
with stage 1 in TF32, the precision below the configuration's float32.
It has to come out not correct against the same limits.

    python3 erbench/control.py --workload <cell> --seeds 11 12 13 [--requests N]

For a batch cell the control scores the cell's whole corpus as a run
would. For a service cell it takes the first ``--requests`` requests of
the cell's clients, round robin, as a window of that many would send
them, and samples them as a run does. Prints one JSON line per seed with
the numbers and the limits. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(cell, requests: int = 0):
    """(numbers, limits) of the TF32 control for ``cell``."""
    import numpy as np

    from erbench import check
    from erbench.data import RequestStream, make_corpus
    from erbench.reference import er as ref

    corpus = make_corpus(cell.config["data"], cell.seed)
    t = cell.traffic
    if t["driver"] == "batch":
        er = dict(cell.config["run_er"], **t.get("run_er", {}))
        strategy = er.get("strategy", "pair_range")
        want = check.batch_expected(corpus.titles, er, strategy, cell.device)
        p = ref.batch_pairs(corpus.titles, er, strategy, cell.device, "tf32")
        h = check.row_hash(ref.encode(corpus.titles, int(er["max_len"]))[0])
        s = p.survives
        lo, hi = np.minimum(p.ia, p.ib), np.maximum(p.ia, p.ib)
        hit = p.matches & (p.ia != p.ib)
        run = {"survivor_hashes": (h[p.ia[s]], h[p.ib[s]]),
               "matches": set(zip(lo[hit].tolist(), hi[hit].tolist()))}
        return check.batch_numbers([run], want), cell.limits
    svc = cell.config["service"]
    streams = [RequestStream(corpus.titles, corpus.key_width, t, cell.seed, c,
                             int(t["requests_per_client"]))
               for c in range(int(t["clients"]))]
    reqs = [streams[i % len(streams)].request(i // len(streams))
            for i in range(requests)]
    occ = collections.Counter(q for r in reqs for q in r)
    rng = np.random.default_rng([int(cell.seed), 104729])
    k = int(svc["prefix_len"])
    size = collections.Counter(ref.prefix_key(x, k) for x in corpus.titles)
    chosen, budget, seen = [], int(cell.check["check_pairs"]), set()
    for i in rng.permutation(len(reqs)):
        if budget <= 0:
            break
        chosen.append(reqs[i])
        new = [q for q in reqs[i] if q not in seen]
        seen.update(new)
        budget -= sum(len(corpus.titles) if ref.prefix_key(q, k) is None
                      else size.get(ref.prefix_key(q, k), 0) for q in new)
    distinct = sorted({q for r in chosen for q in r})
    want = check.service_expected(corpus.titles, distinct, svc, cell.device)
    ctl = check.service_expected(corpus.titles, distinct, svc, cell.device,
                                 "tf32")
    p = ctl["pairs"]
    pos = {q: j for j, q in enumerate(distinct)}
    got = collections.defaultdict(set)
    for a, b in zip(p.ia[p.matches].tolist(), p.ib[p.matches].tolist()):
        got[b].add(a)
    sample = [(r, {(c, j) for j, q in enumerate(r) for c in got[pos[q]]})
              for r in chosen]
    reps = np.asarray([occ[distinct[j]] for j in p.ib], np.int64)
    s = p.survives
    hashes = (np.repeat(ctl["corpus_hash"][p.ia[s]], reps[s]),
              np.repeat(ctl["query_hash"][p.ib[s]], reps[s]))
    return check.service_numbers(want, sample, occ, hashes, 0), cell.limits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    from erbench import check
    from erbench.harness import Layout, make_cell

    layout = Layout(ROOT)
    for seed in args.seeds:
        cell = make_cell(layout, args.workload, seed, 0, False, args.device)
        numbers, limits = control_numbers(cell, args.requests)
        correct, compared = check.verdict(numbers, limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": correct, "check": compared}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

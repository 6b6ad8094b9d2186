"""Chaos drill on the PyTorch port (DESIGN.md §Fault tolerance): replay
a seeded failure script — kills, stragglers, transient errors, corrupted
shards — against a supervised run on 8 logical device shards and watch
tile-granular recovery return the exact quiet match set; then point the
same chaos at a resident ``ERService`` and watch the circuit breaker
evict the dead device and re-admit it after its revive.

    PYTHONPATH=src python examples/torch_chaos_drill.py [--device cpu]

The 8 devices are logical shards of the one ``--device`` (default the
card, which raises without one; ``cpu`` runs the plain versions).
"""
import argparse

import numpy as np

from repro_torch.core import compute_bdm, plan_block_split
from repro_torch.device import resolve_device
from repro_torch.er import ERService, ServiceConfig, make_products
from repro_torch.er.blocking import exponential_block_ids
from repro_torch.er.compiler import (FaultEvent, FaultInjector, FaultScript,
                                     execute, execute_supervised, lower,
                                     plan_to_job)

N_DEV, THRESH = 8, 0.4


def workload():
    """The paper's Fig. 9 robustness workload at s = 1.0: a BlockSplit
    catalog of 64 × 64 tiles over 2,000 unit rows of width 64."""
    rng = np.random.default_rng(9)
    n = 2_000
    bid = exponential_block_ids(n, b=100, s=1.0, rng=rng)
    bdm = compute_bdm(bid, np.zeros(n, np.int64), int(bid.max()) + 1, 1)
    catalog = lower(plan_to_job(plan_block_split(bdm, 32)), 64, 64)
    feats = rng.normal(size=(n, 64)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    return catalog, feats


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(p.parse_args(argv).device)

    catalog, feats = workload()
    quiet = set(zip(*map(np.ndarray.tolist,
                         execute(catalog, feats, threshold=THRESH,
                                 device=dev))))
    print(f"quiet run: {catalog.num_tiles} tiles, {len(quiet)} survivors")

    # ---- executor drill: a seeded random script, replayed ----------------
    script = FaultScript.random(seed=7, n_dev=N_DEV, n_events=6,
                                max_step=24, straggle_delay=1e6,
                                allow_revive=True)
    for e in script.events:
        print(f"  step {e.step:2d}: {e.kind:9s} device {e.device}"
              + (f" (+{e.delay:g}s)" if e.delay else ""))
    ra, rb, rep = execute_supervised(
        catalog, feats, threshold=THRESH, n_dev=N_DEV, shard_deadline=120.0,
        max_retries=8, backoff=0.0, injector=FaultInjector(script, seed=7),
        device=dev)
    assert set(zip(ra.tolist(), rb.tolist())) == quiet     # exact recovery
    assert rep.coverage == 1.0 and rep.retries <= 8
    failed = [r for r in rep.records if r.status != "ok"]
    statuses = sorted({r.status for r in failed})
    print(f"recovered in {rep.rounds} rounds: {len(failed)} failed shards "
          f"({', '.join(statuses or ['none'])}), "
          f"{rep.recovered_tiles} tiles re-executed, coverage {rep.coverage}")
    print(f"final healthy mask: {rep.healthy.astype(int).tolist()}")

    # ---- service drill: circuit breaker evicts, probe re-admits ----------
    ds = make_products(400, seed=3)
    svc = ERService(ds.titles[:320], ServiceConfig(
        feature_dim=128, max_len=48, r=8, m=4, query_buckets=(16,),
        tile_chunk=64, exec_devices=N_DEV, backoff_s=0.0,
        breaker_threshold=1, breaker_cooldown_s=0.0), device=dev)
    svc.set_fault_injector(FaultInjector(FaultScript(events=(
        FaultEvent("kill", 2, 0), FaultEvent("corrupt", 4, 4),
        FaultEvent("revive", 2, 25)), n_dev=N_DEV)))
    batches = []
    for i in range(6):
        batch = ds.titles[320 + i * 13:320 + (i + 1) * 13]
        resp = svc.match(batch)
        evicted = sorted(svc._breaker_open)
        batches.append([len(resp), resp.attempts, resp.coverage, evicted])
        print(f"batch {i}: {len(resp)} matches, attempts {resp.attempts}, "
              f"coverage {resp.coverage}, evicted {evicted}")
    s = svc.stats
    assert s["degraded"] == 0
    print(f"\nbreaker: {s['breaker_evictions']} evictions, "
          f"{s['breaker_readmissions']} readmissions; "
          f"{s['retries']} request retries, "
          f"{s['recovered_tiles']} tiles recovered — every response exact")
    return {"tiles": catalog.num_tiles, "survivors": len(quiet),
            "rounds": rep.rounds, "retries": rep.retries,
            "failed_shards": len(failed), "failed_statuses": statuses,
            "recovered_tiles": rep.recovered_tiles,
            "coverage": rep.coverage,
            "healthy": rep.healthy.astype(int).tolist(),
            "service_batches": batches,
            "evictions": s["breaker_evictions"],
            "readmissions": s["breaker_readmissions"],
            "request_retries": s["retries"],
            "service_recovered_tiles": s["recovered_tiles"],
            "degraded": s["degraded"]}


if __name__ == "__main__":
    main()

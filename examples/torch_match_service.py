"""Resident ER service on the PyTorch port: ingest a product corpus
once, then answer match micro-batches from the warm kernels — the
serving analog of the batch ``run_er`` pipeline (paper Fig. 2), built on
the two-source R × S plans of Appendix I.

    PYTHONPATH=src python examples/torch_match_service.py [--device cpu]

``compile_counter`` counts the port's run-time builds: each nvcc build
of a kernel source and each first load of a kernel library. After the
warm-up the steady state must build and load nothing (asserted).
``--device`` defaults to the card and raises without one; ``cpu`` runs
the kernels' plain PyTorch versions (nothing to build).
"""
import argparse

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.er import (ERService, ServiceConfig, compile_counter,
                            make_products)

CORPUS_N, BATCHES = 3_000, 8


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(p.parse_args(argv).device)

    ds = make_products(CORPUS_N, seed=0)

    # Ingest once: features + block layout go resident, the BDM stays
    # host-side.
    cfg = ServiceConfig(feature_dim=128, max_len=48, r=16, m=4,
                        query_buckets=(8, 32, 128), tile_chunk=128)
    svc = ERService(ds.titles, cfg, device=dev)
    print(f"ingested {svc.n_corpus} entities, {svc.bdm.shape[0]} blocks, "
          f"{svc.ingest_seconds * 1e3:.0f} ms")

    with compile_counter() as warm:
        svc.warmup()
    print(f"warmup built or loaded {warm.count} kernel libraries (nvcc "
          f"builds and first loads)")

    # Steady state: perturbed corpus titles (≈ near-duplicates), a null-key
    # query, and a never-seen block — no build or load from here on.
    rng = np.random.default_rng(1)
    per_batch = []
    with compile_counter() as steady:
        for i in range(BATCHES):
            size = int(rng.integers(1, 100))
            batch = []
            for _ in range(size):
                t = ds.titles[int(rng.integers(0, len(ds.titles)))]
                s = list(t)
                s[int(rng.integers(3, len(s)))] = "x"
                batch.append("".join(s))
            if i == 3:
                batch[0] = ""                        # null key → match_⊥ path
            if i == 5:
                batch[0] = "@@@ brand new block"     # grows the BDM
            found = svc.match(batch)
            per_batch.append([len(batch), len(found)])
            print(f"batch {i}: {len(batch):3d} queries → {len(found):3d} "
                  f"matches")
            for c, q in sorted(found)[:2]:
                print(f"    corpus[{c}] {ds.titles[c]!r}  ≈  query "
                      f"{batch[q]!r}")
    assert steady.count == 0, f"{steady.count} builds in steady state"

    s = svc.stats
    print(f"\nserved {s['queries']} queries in {s['batches']} batches, "
          f"{s['matches']} matches, {s['planned_pairs']:,} planned cross "
          f"pairs, {s['queries'] / max(s['seconds'], 1e-9):,.0f} queries/s, "
          f"{steady.count} steady-state builds")
    print("bucket hits:", s["bucket_hits"])
    top5 = np.sort(svc.traffic_bdm[:, 0])[::-1][:5].tolist()
    print("traffic skew (top-5 blocks):", top5)
    return {"n_corpus": svc.n_corpus, "blocks": int(svc.bdm.shape[0]),
            "warmup_builds": warm.count, "batches": per_batch,
            "queries": s["queries"], "matches": s["matches"],
            "planned_pairs": s["planned_pairs"],
            "steady_builds": steady.count,
            "bucket_hits": dict(s["bucket_hits"]), "traffic_top5": top5}


if __name__ == "__main__":
    main()

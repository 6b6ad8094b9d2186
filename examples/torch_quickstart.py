"""Quickstart on the PyTorch port: the paper's workflow in 30 lines.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Deduplicates a 5k-product catalog three ways (Basic / BlockSplit /
PairRange) with ``repro_torch.er.run_er`` and prints the skew story:
identical matches, wildly different load balance. ``--device`` defaults
to the card (stage 1 on the catalog kernel) and raises without one;
``cpu`` runs the kernels' plain PyTorch versions.
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.er import ERConfig, make_products, run_er


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(p.parse_args(argv).device)

    ds = make_products(5_000, seed=0)
    print(f"dataset: {ds.n} product titles, {len(ds.true_pairs)} injected "
          f"duplicates")
    out = {"n": ds.n, "true_pairs": len(ds.true_pairs), "strategies": {}}
    for strategy in ("basic", "block_split", "pair_range"):
        cfg = ERConfig(strategy=strategy, r=16, m=8)
        res = run_er(ds.titles, cfg, device=dev)
        recall = len(res.matches & ds.true_pairs) / len(ds.true_pairs)
        loads = res.reducer_pairs
        balance = loads.max() / max(loads.mean(), 1)
        print(f"{strategy:12s} pairs={res.total_pairs:>9,} "
              f"matches={len(res.matches):>5} recall={recall:.3f} "
              f"max/mean load={balance:>6.2f} "
              f"modeled-makespan={res.makespan_seconds:.2f}s "
              f"map-output={res.map_output_size}")
        out["strategies"][strategy] = {
            "pairs": int(res.total_pairs), "matches": len(res.matches),
            "recall": round(recall, 3), "max_mean_load": round(float(balance), 2),
            "map_output": int(res.map_output_size)}

    print("\nthe point: one block holds ~70% of all pairs — Basic pins it to "
          "a single reducer;\nBlockSplit/PairRange split it, with identical "
          "match output.")
    return out


if __name__ == "__main__":
    main()

"""Sorted Neighborhood quickstart on the PyTorch port (arXiv:1010.3053
meets the load-balanced executor): dedup a product catalog by sliding a
window over the title sort order instead of blocking on a key prefix.

    PYTHONPATH=src python examples/torch_dedup_sorted_neighborhood.py [--device cpu]

SN trades the block distribution's skew problem for a fixed O(n·w) band:
the planner range-partitions the band's pair-index space into r balanced
reduce tasks (imbalance ≈ 1 by construction), and the band compiles to
diagonal-hugging tiles scored by the same catalog kernel the blocking
strategies use. ``--device`` defaults to the card and raises without
one; ``cpu`` runs the kernels' plain PyTorch versions.
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.er import ERConfig, make_products, run_er


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(p.parse_args(argv).device)

    ds = make_products(8_000, seed=0)
    out = {"windows": {}}
    last = None
    for window in (5, 10, 50):
        cfg = ERConfig(strategy="sorted_neighborhood", window=window, r=32)
        last = res = run_er(ds.titles, cfg, device=dev)
        recall = len(res.matches & ds.true_pairs) / len(ds.true_pairs)
        loads = res.reducer_pairs
        imbalance = loads.max() / loads.mean()
        print(f"w={window:3d}  band pairs={res.total_pairs:>9,}  "
              f"map kv={res.map_output_size:>7,}  "
              f"imbalance={imbalance:.3f}  "
              f"matches={len(res.matches):>5}  recall={recall:.3f}")
        out["windows"][window] = {
            "pairs": int(res.total_pairs),
            "map_output": int(res.map_output_size),
            "imbalance": round(float(imbalance), 3),
            "matches": len(res.matches), "recall": round(recall, 3)}

    # the blocking baseline: same matcher, different search space
    base = run_er(ds.titles, ERConfig(strategy="pair_range", r=32),
                  device=dev)
    recall = len(base.matches & ds.true_pairs) / len(ds.true_pairs)
    ratio = last.total_pairs / max(base.total_pairs, 1)
    print(f"\npair_range baseline: {base.total_pairs:,} pairs, "
          f"recall={recall:.3f} — SN at w=50 searches {ratio:.1f}× that, but "
          f"needs no blocking key and cannot be skewed by one")
    out["baseline"] = {"pairs": int(base.total_pairs),
                       "matches": len(base.matches),
                       "recall": round(recall, 3)}
    return out


if __name__ == "__main__":
    main()

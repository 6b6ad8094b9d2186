"""Two-source entity resolution on the PyTorch port (paper Appendix I):
match a 'store A' catalog against a 'store B' catalog — only
cross-source pairs compared, with PairRange balancing over the
rectangular |Φ_R|×|Φ_S| enumeration.

    PYTHONPATH=src python examples/torch_dedup_two_sources.py [--device cpu]

The cosine pre-filter stays in numpy; only the exact edit similarity
(integer distances) runs on ``--device``, so the match list is exact on
every device. ``--device`` defaults to the card and raises without one.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import compute_bdm
from repro_torch.core.two_source import (TwoSourceBDM, pairs_of_range_2src,
                                         plan_pair_range_2src)
from repro_torch.device import resolve_device
from repro_torch.er import make_products
from repro_torch.er.blocking import prefix_block_ids
from repro_torch.er.encode import encode_titles, ngram_features
from repro_torch.er.similarity import edit_similarity

R_SIZE, S_SIZE, R_TASKS = 3_000, 2_000, 12


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(p.parse_args(argv).device)

    # two overlapping catalogs: B perturbs a slice of A's titles
    a = make_products(R_SIZE, seed=0)
    b = make_products(S_SIZE, seed=0)      # same generator seed → overlaps
    r_titles, s_titles = a.titles, b.titles

    # shared dense block space over both sources (3-char prefix)
    all_ids, _ = prefix_block_ids(r_titles + s_titles, a.prefix_len)
    rid, sid = all_ids[:len(r_titles)], all_ids[len(r_titles):]
    nb = int(all_ids.max()) + 1
    bdm2 = TwoSourceBDM(
        bdm_r=compute_bdm(rid, np.zeros_like(rid), nb, 1),
        bdm_s=compute_bdm(sid, np.zeros_like(sid), nb, 1))

    plan = plan_pair_range_2src(bdm2, R_TASKS)
    print(f"R={len(r_titles)} S={len(s_titles)} blocks={nb} "
          f"cross pairs={plan.total_pairs:,} "
          f"pairs/reducer={plan.reducer_pairs.tolist()[:6]}…")

    # each source's entities in the blocked layout
    r_order = np.argsort(rid, kind="stable")
    s_order = np.argsort(sid, kind="stable")
    rc, rl = encode_titles([r_titles[i] for i in r_order])
    sc, sl = encode_titles([s_titles[i] for i in s_order])
    rf = ngram_features(rc, lengths=rl)
    sf = ngram_features(sc, lengths=sl)
    # codes and lengths go to the device once
    rc_d, rl_d = torch.from_numpy(rc).to(dev), torch.from_numpy(rl).to(dev)
    sc_d, sl_d = torch.from_numpy(sc).to(dev), torch.from_numpy(sl).to(dev)

    matches = []
    for k in range(R_TASKS):
        _, _, _, rr, ss = pairs_of_range_2src(plan, k)
        if rr.size == 0:
            continue
        cos = np.einsum("pd,pd->p", rf[rr], sf[ss])
        cand = np.flatnonzero(cos >= 0.55)
        if cand.size == 0:
            continue
        ia = torch.from_numpy(rr[cand]).to(dev)
        ib = torch.from_numpy(ss[cand]).to(dev)
        sim = edit_similarity(rc_d[ia], rl_d[ia], sc_d[ib],
                              sl_d[ib]).cpu().numpy()
        hit = cand[sim >= 0.8]
        matches.extend((int(r_order[rr[i]]), int(s_order[ss[i]]))
                       for i in hit)

    print(f"cross-source matches: {len(matches)}; sample:")
    for ri, si in matches[:5]:
        print(f"  A[{ri}] {r_titles[ri]!r}  ≈  B[{si}] {s_titles[si]!r}")
    return {"r": len(r_titles), "s": len(s_titles), "blocks": nb,
            "cross_pairs": int(plan.total_pairs),
            "reducer_pairs": [int(x) for x in plan.reducer_pairs],
            "matches": matches}


if __name__ == "__main__":
    main()

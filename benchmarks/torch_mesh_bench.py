"""2-D mesh scale-out on the port — comms-policy parity and interconnect
bytes (torch leg of ``mesh_bench``).

Runs the full ``run_er`` pipeline on meshes of LOGICAL shards of the
leg's one device (``make_er_mesh(n_data, n_model, devices=[dev] * n)``:
every shard lies on the same card, or on the CPU) and compares the three
stage-1 gather policies on the ``data`` axis — flat all-gather, ring
strip pipeline, hierarchical group exchange — plus the data × model
mesh (feature columns sharded, partial tile scores psum-combined) and
the multi-hop RepSN halo executor at a window wider than a shard.

Asserted in :func:`measure` (exact): every comms policy and the data ×
model mesh give EXACTLY the one-device match set, no plan degrades to
flat, and the multi-hop halo (w − 1 > n / n_data) matches the one-device
SN pipeline with >= 2 hops whose byte schedule sums to exactly (w − 1)
feature rows per device. Asserted in :func:`check`: at 16 shards the
ring receives >= 2x fewer gather bytes per device than the flat
all-gather.

Bytes are the executor's own per-device accounting
(``stage1_stats["interconnect"]``, counted per kernel launch), equal to
the JAX leg's row for row. ``wall_s`` is ONE device's wall time with
every logical shard on it: no bytes cross a wire, so it measures the
shards' kernels and the gathers' copies within one card, not a mesh.
Stage 1 runs K1 on the card.

    PYTHONPATH=src python -m benchmarks.torch_mesh_bench [--quick] [--device cpu|cuda]
"""
from __future__ import annotations

import time
from dataclasses import replace

import torch

from repro_torch.device import resolve_device
from repro_torch.er import ERConfig, make_products, run_er
from repro_torch.er.blocking import sn_sort_order
from repro_torch.er.compiler import stage1_stats, verify_pairs
from repro_torch.er.distributed import match_sn_dist, sn_replication_volume
from repro_torch.er.encode import encode_titles, ngram_features
from repro_torch.sharding import make_er_mesh

from .common import print_table, save_rows
from .torch_common import cli, count_view, impl_of

FLOWS = ("flat_bytes", "ring_bytes", "hier_intra_bytes", "hier_inter_bytes",
         "halo_bytes", "psum_bytes")
QUICK_LEGS = ((16, 1, 2000), (4, 2, 640))          # (n_data, n_model, n)
FULL_LEGS = ((8, 1, 4000), (16, 1, 4000), (4, 2, 2000))
# Every column equals the JAX leg's row for row (wall_s is the clock).
COUNTS = ("leg", "policy", "n_data", "n_model", "matches", "equal",
          "gather_bytes_per_dev", "psum_bytes_per_dev", "fallback", "hops",
          "hop_bytes_ok", "reduction_x")


def _snap():
    return {k: stage1_stats["interconnect"][k] for k in FLOWS}


def leg(n_data: int, n_model: int, n_corpus: int, dev) -> list:
    """One mesh leg on ``n_data × n_model`` logical shards of ``dev``: the
    three gather policies through ``run_er``, then the multi-hop halo."""
    cfg = ERConfig(strategy="pair_range", r=32, m=8, feature_dim=128,
                   max_len=48, kernel_impl=impl_of(dev))
    titles = make_products(n_corpus, seed=3).titles
    mesh = make_er_mesh(n_data, n_model, devices=[dev] * (n_data * n_model))
    rows = []

    host = run_er(titles, cfg, device=dev)
    for comms in ("flat", "ring", "hierarchical"):
        before = _snap()
        t0 = time.perf_counter()
        res = run_er(titles, replace(cfg, comms=comms), mesh=mesh,
                     device=dev)
        wall = time.perf_counter() - t0
        d = {k: stage1_stats["interconnect"][k] - before[k] for k in FLOWS}
        rows.append({
            "leg": "comms", "policy": comms,
            "n_data": n_data, "n_model": n_model,
            "matches": len(res.matches),
            "equal": res.matches == host.matches,
            "gather_bytes_per_dev": (d["flat_bytes"] + d["ring_bytes"]
                                     + d["hier_intra_bytes"]
                                     + d["hier_inter_bytes"]),
            "psum_bytes_per_dev": d["psum_bytes"],
            "fallback": res.extra.get("comms_fallback"),
            "wall_s": round(wall, 4),
        })

    # ---- multi-hop RepSN halo: w − 1 > n / n_data ----
    n_sn = len(titles) - (len(titles) % n_data)
    sn_titles = titles[:n_sn]
    n_loc = n_sn // n_data
    w = n_loc + max(n_loc // 4, 2)        # 2 chained hops
    sn_host = run_er(sn_titles, replace(
        cfg, strategy="sorted_neighborhood", window=w, r=n_data),
        device=dev)
    order = sn_sort_order(sn_titles)
    codes, lens = encode_titles(sn_titles, cfg.max_len)
    feats = ngram_features(codes, dim=cfg.feature_dim, lengths=lens)
    before = _snap()
    t0 = time.perf_counter()
    ca, cb = match_sn_dist(torch.from_numpy(feats[order]).to(dev), w, mesh,
                           threshold=cfg.threshold - cfg.filter_margin,
                           impl=cfg.kernel_impl)
    halo_recv = stage1_stats["interconnect"]["halo_bytes"] \
        - before["halo_bytes"]
    ha, hb = verify_pairs(codes[order], lens[order], codes[order],
                          lens[order], ca, cb, cfg.threshold, device=dev)
    wall = time.perf_counter() - t0
    got = {(min(int(order[a]), int(order[b])), max(int(order[a]),
                                                   int(order[b])))
           for a, b in zip(ha, hb)}
    per_hop = sn_replication_volume(n_sn, w, n_data, cfg.feature_dim,
                                    per_hop=True)
    rows.append({
        "leg": "halo", "policy": "multi-hop",
        "n_data": n_data, "n_model": n_model,
        "matches": len(got), "equal": got == sn_host.matches,
        "gather_bytes_per_dev": halo_recv,
        "psum_bytes_per_dev": 0,
        "hops": len(per_hop),
        "hop_bytes_ok": sum(per_hop) == (w - 1) * cfg.feature_dim * 4,
        "wall_s": round(wall, 4),
    })
    return rows


def _by_policy(rows):
    return {(r["n_data"], r["n_model"], r["policy"]): r
            for r in rows if r["leg"] == "comms"}


def measure(quick: bool = False, device="cuda", legs=None):
    """Every leg (``legs``, else the quick or full set), the exact
    assertions, and each policy's ``reduction_x`` against flat."""
    dev = resolve_device(device)
    legs = legs or (QUICK_LEGS if quick else FULL_LEGS)
    rows = []
    for n_data, n_model, n_corpus in legs:
        rows.extend(leg(n_data, n_model, n_corpus, dev))
    for r in rows:
        assert r["equal"], f"match-set mismatch: {r}"
        assert not r.get("fallback"), f"plan degraded to flat: {r}"
        if r["leg"] == "halo":
            assert r["hops"] >= 2 and r["hop_bytes_ok"], r
    by = _by_policy(rows)
    for r in rows:
        if r["leg"] == "comms" and r["policy"] != "flat":
            flat = by[(r["n_data"], r["n_model"], "flat")]
            r["reduction_x"] = round(flat["gather_bytes_per_dev"]
                                     / max(r["gather_bytes_per_dev"], 1), 1)
    print_table(f"Mesh scale-out on logical shards of ONE {dev} (wall_s: "
                f"one device's clock, every shard on it) — gather policy "
                f"parity + exact interconnect bytes/device", rows,
                cols=list(COUNTS) + ["wall_s"])
    save_rows("torch_mesh_bench", rows)
    return rows


def counts(rows):
    """The count columns, in row order."""
    return count_view(rows, COUNTS)


def check(rows):
    """The JAX leg's byte bar: at 16 shards the ring receives >= 2x fewer
    gather bytes per device than the flat all-gather."""
    by = _by_policy(rows)
    flat = by[(16, 1, "flat")]["gather_bytes_per_dev"]
    ring = by[(16, 1, "ring")]["gather_bytes_per_dev"]
    assert flat >= 2 * max(ring, 1), \
        f"ring gather {ring} not >= 2x below flat {flat} at 16 shards"
    print(f"\nOK: exact match-set equality on every leg; ring cuts gather "
          f"bytes/device {flat / max(ring, 1):.1f}x vs flat at 16 shards; "
          f"multi-hop halo exact past the single-shard window")


def run(quick: bool = False, device="cuda"):
    rows = measure(quick=quick, device=device)
    check(rows)
    return rows


if __name__ == "__main__":
    raise SystemExit(cli(run, __doc__))

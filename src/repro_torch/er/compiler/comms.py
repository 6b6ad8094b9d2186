"""Interconnect planning for the 2-D (``data`` × ``model``) mesh executor.

Port of ``repro.er.compiler.comms`` (numpy, copied as it is).

The flat executor all_gathers the whole a-side feature matrix onto every
device — bytes received per device grow O(n) regardless of what the
device's tiles actually read. This module plans the two cheaper gather
policies (DESIGN.md §Mesh scale-out) and accounts every data flow's
wire bytes exactly:

  * **ring** — *locality placement*: every tile lands on the device that
    owns its MINIMUM needed strip (strip = contiguous n_loc-row shard),
    so all strips a device needs are strictly *forward* of its own and
    the global hop count H = max over tiles of (max strip − min strip).
    H chained ``ppermute`` hops assemble, per device, the contiguous
    global row window [d·n_loc, d·n_loc + (H+1)·n_loc) — bytes received
    drop from O(n) to O(n_loc · H). For blocked ER plans tiles live
    inside block rectangles, so H is small while a flat gather still
    pays n − n_loc.
  * **hierarchical** — devices form groups of g consecutive strips:
    an intra-group ring (g − 1 hops of n_loc rows) assembles each
    group's panel, then Hg inter-group hops at stride g exchange whole
    g·n_loc-row panels. Same locality argument one level up (group =
    min needed strip's group; within the group the g members are free,
    so tiles LPT-balance across them — the placement freedom ring gives
    up). Bytes: (g−1)·n_loc + Hg·g·n_loc rows per device.
  * **psum** (model axis) — features column-sharded d/n_model per
    device; per-tile partial scores combine with one psum over
    ``model``. A ring all-reduce of a P-byte payload receives
    2·(n_model−1)/n_model · P bytes per device.
  * **halo** (RepSN) — ⌈halo/n_loc⌉ chained neighbor hops, the last hop
    sending only the final partial strip, so received bytes are exactly
    halo · row_bytes per device (see ``halo_hop_rows``).

Every formula here is the single source of truth: the executor records
the same numbers into ``stage1_stats["interconnect"]`` and
``Schedule.stats()`` surfaces them via the plan, and ``chip_smoke.py``'s mesh
phase asserts the ring/flat ratio they predict.

The local-coordinate contract: ring/hierarchical buffers are contiguous
global row windows starting at ``base[dev]``, so tiles rewrite to buffer
coordinates by a uniform shift (``rewrite_tiles_local``) — which is only
exact when n_loc is a multiple of the tile geometry. ``plan_comms``
degrades to flat (with ``fallback`` naming the reason) whenever the
preconditions fail, so callers never have to pre-validate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .ir import (A_TILE, B_TILE, R0, R1, C0, C1, LB_R, LB_C, UB_R, UB_C,
                 BAND, TileCatalog)

__all__ = [
    "COMMS_POLICIES",
    "CommsPlan",
    "plan_comms",
    "comms_volume",
    "rewrite_tiles_local",
    "halo_hop_rows",
    "halo_bytes_per_device",
    "psum_bytes_per_device",
    "default_group",
]

COMMS_POLICIES = ("flat", "ring", "hierarchical")


def default_group(n_data: int) -> int:
    """Largest divisor of n_data that is <= sqrt(n_data) — the balanced
    two-level split (16 → 4×4, 8 → 2×4, primes → 1, i.e. degenerate)."""
    g = 1
    for cand in range(1, int(np.sqrt(n_data)) + 1):
        if n_data % cand == 0:
            g = cand
    return g


def halo_hop_rows(n_loc: int, halo: int) -> List[int]:
    """Rows received per hop of the multi-hop halo chain: full strips for
    every hop but the last, which sends only the final partial strip —
    the schedule the executor implements, summing to exactly ``halo``."""
    if halo <= 0:
        return []
    hops = -(-halo // n_loc)
    take = halo - (hops - 1) * n_loc
    return [n_loc] * (hops - 1) + [take]


def halo_bytes_per_device(n_loc: int, halo: int, feature_dim: int,
                          itemsize: int = 4) -> List[int]:
    """Per-hop bytes received per device for the RepSN halo exchange."""
    return [r * feature_dim * itemsize for r in halo_hop_rows(n_loc, halo)]


def psum_bytes_per_device(n_model: int, num_tiles: int, block_m: int,
                          block_n: int, itemsize: int = 4) -> int:
    """Bytes received per device by the model-axis psum of ``num_tiles``
    partial-score tiles (ring all-reduce accounting: each device receives
    2·(n_model−1)/n_model of the f32 payload)."""
    if n_model <= 1:
        return 0
    payload = num_tiles * block_m * block_n * itemsize
    return int(2 * (n_model - 1) * payload // n_model)


@dataclass(frozen=True)
class CommsPlan:
    """A resolved gather policy for one catalog on one mesh geometry:
    the locality tile placement, the hop counts the scorer must compile
    with, the buffer origins that shift local survivor coordinates back
    to global rows, and the exact per-flow byte accounting."""
    policy: str                    # resolved: flat | ring | hierarchical
    requested: str                 # what the caller asked for
    n_data: int
    n_model: int
    n_loc: int                     # a-side rows per data shard
    hops: int                      # ring: chained ppermute hops
    group: int                     # hierarchical: devices per group (g)
    inter_hops: int                # hierarchical: group-panel hops
    self_join: bool
    feature_dim: int
    device_of_tile: Optional[np.ndarray] = None   # (T,) locality placement
    base: Optional[np.ndarray] = None             # (n_data,) buffer origins
    itemsize: int = 4
    fallback: Optional[str] = None  # why the request degraded to flat

    @property
    def buffer_rows(self) -> int:
        """Rows of the assembled per-device feature buffer."""
        if self.policy == "ring":
            return (self.hops + 1) * self.n_loc
        if self.policy == "hierarchical":
            return (self.inter_hops + 1) * self.group * self.n_loc
        return self.n_loc * self.n_data

    def bytes_received_per_device(self) -> Dict[str, int]:
        """Exact interconnect bytes RECEIVED per device, per flow.

        ``psum`` is omitted here (it depends on launched tile counts —
        the executor records it into ``stage1_stats`` exactly); the
        gather flows are pure functions of the plan."""
        row = (self.feature_dim // max(self.n_model, 1)) * self.itemsize
        if self.n_data <= 1:
            return {"total": 0}
        if self.policy == "ring":
            out = {"ring_hop": self.n_loc * row,
                   "ring": self.hops * self.n_loc * row}
            out["total"] = out["ring"]
            return out
        if self.policy == "hierarchical":
            intra = (self.group - 1) * self.n_loc * row
            inter = self.inter_hops * self.group * self.n_loc * row
            return {"hier_intra": intra, "hier_inter": inter,
                    "total": intra + inter}
        flat = (self.n_data - 1) * self.n_loc * row
        return {"flat_gather": flat, "total": flat}

    def summary(self) -> Dict:
        """JSON-able plan report (lands on ``Schedule.stats()``)."""
        out = {
            "policy": self.policy,
            "requested": self.requested,
            "n_data": self.n_data,
            "n_model": self.n_model,
            "n_loc": self.n_loc,
            "hops": self.hops,
            "group": self.group,
            "inter_hops": self.inter_hops,
            "buffer_rows": self.buffer_rows,
            "bytes_received_per_device": self.bytes_received_per_device(),
        }
        if self.fallback:
            out["fallback"] = self.fallback
        return out


def _tile_row_spans(tiles: np.ndarray, bm: int, bn: int,
                    self_join: bool) -> tuple:
    """(lo, hi, live) — the a-side feature rows each tile actually reads:
    its row window clipped to the tile, unioned (self-join) with its
    column window, since self-join columns index the same matrix.
    ``hi`` is exclusive; dead tiles (empty windows) report (0, 0)."""
    t = tiles.astype(np.int64)
    a_lo = np.maximum(t[:, R0], t[:, A_TILE] * bm)
    a_hi = np.minimum(t[:, R1], (t[:, A_TILE] + 1) * bm)
    live = a_hi > a_lo
    lo, hi = a_lo, a_hi
    if self_join:
        b_lo = np.maximum(t[:, C0], t[:, B_TILE] * bn)
        b_hi = np.minimum(t[:, C1], (t[:, B_TILE] + 1) * bn)
        live = live & (b_hi > b_lo)
        lo = np.minimum(lo, b_lo)
        hi = np.maximum(hi, b_hi)
    lo = np.where(live, lo, 0)
    hi = np.where(live, hi, 0)
    return lo, hi, live


def _flat(requested: str, n_data: int, n_model: int, n_loc: int,
          self_join: bool, feature_dim: int, itemsize: int,
          reason: Optional[str]) -> CommsPlan:
    return CommsPlan(policy="flat", requested=requested, n_data=n_data,
                     n_model=n_model, n_loc=n_loc, hops=0, group=1,
                     inter_hops=0, self_join=self_join,
                     feature_dim=feature_dim, itemsize=itemsize,
                     fallback=reason)


def plan_comms(catalog: TileCatalog, n_rows: int, n_data: int, *,
               policy: str = "ring", n_model: int = 1,
               feature_dim: int, self_join: bool = True,
               group: Optional[int] = None, itemsize: int = 4,
               pin_hops: Optional[int] = None,
               pin_inter_hops: Optional[int] = None) -> CommsPlan:
    """Resolve a gather policy for ``catalog`` over ``n_data`` shards of
    an ``n_rows``-row a-side feature matrix (the *sharded* length —
    including any residency padding, which tiles never reference).

    Placement is locality-first: each tile goes to the owner of its
    minimum needed strip (ring) or to an LPT-balanced member of that
    strip's group (hierarchical), which is what bounds the hop count.
    ``pin_hops`` / ``pin_inter_hops`` freeze the compiled hop count (the
    resident service's zero-recompile contract): plans whose tiles need
    more hops than the pin degrade to flat instead of recompiling.

    Degrades to ``policy="flat"`` — with ``fallback`` naming the reason
    — whenever the local-coordinate rewrite cannot be exact: n_rows not
    shard-divisible, n_loc not a multiple of the tile geometry, or a
    banded self-join rewrite that a cross-side shift would skew.
    """
    if policy not in COMMS_POLICIES:
        raise ValueError(f"unknown comms policy {policy!r}")
    if feature_dim % max(n_model, 1):
        raise ValueError(
            f"feature_dim={feature_dim} not divisible by n_model={n_model}")
    n_loc = n_rows // n_data if n_data else n_rows
    if policy == "flat" or n_data <= 1:
        return _flat(policy, n_data, n_model, n_loc, self_join,
                     feature_dim, itemsize, None)
    bm, bn = catalog.block_m, catalog.block_n
    if n_rows % n_data:
        return _flat(policy, n_data, n_model, n_loc, self_join, feature_dim,
                     itemsize, f"n_rows={n_rows} not divisible by "
                               f"n_data={n_data}")
    if n_loc % bm or (self_join and n_loc % bn):
        return _flat(policy, n_data, n_model, n_loc, self_join, feature_dim,
                     itemsize, f"n_loc={n_loc} not a multiple of the tile "
                               f"geometry ({bm}, {bn})")
    if not self_join and (catalog.tiles[:, BAND] > 0).any():
        # A banded predicate compares col − row; a cross-mode rewrite
        # shifts rows only, which would skew the band.
        return _flat(policy, n_data, n_model, n_loc, self_join, feature_dim,
                     itemsize, "banded tiles in cross mode")

    lo, hi, live = _tile_row_spans(catalog.tiles, bm, bn, self_join)
    s_min = np.where(live, lo // n_loc, 0)
    s_max = np.where(live, np.maximum(hi - 1, 0) // n_loc, 0)

    if policy == "ring":
        hops = int((s_max - s_min).max(initial=0))
        if pin_hops is not None:
            if hops > pin_hops:
                return _flat(policy, n_data, n_model, n_loc, self_join,
                             feature_dim, itemsize,
                             f"tile span needs {hops} hops > pinned "
                             f"{pin_hops}")
            hops = pin_hops
        return CommsPlan(policy="ring", requested=policy, n_data=n_data,
                         n_model=n_model, n_loc=n_loc, hops=hops, group=1,
                         inter_hops=0, self_join=self_join,
                         feature_dim=feature_dim,
                         device_of_tile=s_min.astype(np.int64),
                         base=np.arange(n_data, dtype=np.int64) * n_loc,
                         itemsize=itemsize)

    g = group if group is not None else default_group(n_data)
    if g < 1 or n_data % g:
        raise ValueError(f"group={g} does not divide n_data={n_data}")
    g_min = s_min // g
    g_max = s_max // g
    inter = int((g_max - g_min).max(initial=0))
    if pin_inter_hops is not None:
        if inter > pin_inter_hops:
            return _flat(policy, n_data, n_model, n_loc, self_join,
                         feature_dim, itemsize,
                         f"tile span needs {inter} group hops > pinned "
                         f"{pin_inter_hops}")
        inter = pin_inter_hops
    # Within each group the g members all hold the same buffer, so
    # placement is free — LPT-balance by exact tile cost.
    from .schedule import tile_costs
    costs = tile_costs(catalog)
    device_of = np.zeros(catalog.num_tiles, np.int64)
    for grp in np.unique(g_min):
        mine = np.flatnonzero(g_min == grp)
        order = mine[np.argsort(-costs[mine], kind="stable")]
        load = np.zeros(g, np.int64)
        for ti in order:
            d = int(load.argmin())
            device_of[ti] = grp * g + d
            load[d] += costs[ti]
    base = (np.arange(n_data, dtype=np.int64) // g) * g * n_loc
    return CommsPlan(policy="hierarchical", requested=policy, n_data=n_data,
                     n_model=n_model, n_loc=n_loc, hops=0, group=g,
                     inter_hops=inter, self_join=self_join,
                     feature_dim=feature_dim, device_of_tile=device_of,
                     base=base, itemsize=itemsize)


def comms_volume(catalog: TileCatalog, n_rows: int, n_dev: int, *,
                 feature_dim: int, self_join: bool = True,
                 group: Optional[int] = None,
                 itemsize: int = 4) -> Dict[str, int]:
    """Model-only per-device byte table for a scaling sweep: the bytes
    each policy WOULD receive per device at ``n_dev`` shards, with no
    executor preconditions (strips are ⌈n/n_dev⌉ rows; geometry
    divisibility is irrelevant to the accounting). Used by the fig13
    sweep; ``plan_comms`` is the executor's exact sibling."""
    n_loc = max(-(-n_rows // n_dev), 1)
    row = feature_dim * itemsize
    if n_dev <= 1:
        return {"flat_gather": 0, "ring": 0, "hier_intra": 0,
                "hier_inter": 0, "ring_hops": 0, "hier_inter_hops": 0}
    lo, hi, live = _tile_row_spans(catalog.tiles, catalog.block_m,
                                   catalog.block_n, self_join)
    s_min = np.where(live, lo // n_loc, 0)
    s_max = np.where(live, np.maximum(hi - 1, 0) // n_loc, 0)
    hops = int((s_max - s_min).max(initial=0))
    g = group if group is not None else default_group(n_dev)
    inter = int((s_max // g - s_min // g).max(initial=0)) if g else 0
    return {
        "flat_gather": (n_dev - 1) * n_loc * row,
        "ring": hops * n_loc * row,
        "hier_intra": (g - 1) * n_loc * row,
        "hier_inter": inter * g * n_loc * row,
        "ring_hops": hops,
        "hier_inter_hops": inter,
    }


def rewrite_tiles_local(tiles_dev: np.ndarray, base: np.ndarray,
                        bm: int, bn: int,
                        shift_b: bool = True) -> np.ndarray:
    """Shift per-device tiles from global to buffer-local coordinates.

    Device d's assembled buffer is the contiguous global row window
    starting at ``base[d]``, so the rewrite is a uniform translation:
    row coordinates (A_TILE, R0, R1, LB_R, UB_R) drop base[d] (A_TILE in
    units of bm); with ``shift_b`` (self-join — columns index the same
    buffer) the column coordinates (B_TILE, C0, C1, LB_C, UB_C) drop it
    too. Every catalog predicate is a translation-invariant comparison
    (the band needs BOTH sides shifted — cross mode must not carry
    bands, which ``plan_comms`` guarantees); the NO_LB/NO_UB sentinels
    shift to equally-inert values. All-zero padding entries (empty
    windows) stay untouched so their tile indices remain in range."""
    b64 = np.asarray(base, np.int64)
    if (b64 % bm).any() or (shift_b and (b64 % bn).any()):
        raise ValueError("buffer origins must be tile-aligned")
    out = tiles_dev.astype(np.int64, copy=True)
    live = out[:, :, R1] > out[:, :, R0]
    b = b64[:, None]
    for col, unit in ((A_TILE, bm), (R0, 1), (R1, 1), (LB_R, 1), (UB_R, 1)):
        out[:, :, col] = np.where(live, out[:, :, col] - b // unit,
                                  out[:, :, col])
    if shift_b:
        for col, unit in ((B_TILE, bn), (C0, 1), (C1, 1), (LB_C, 1),
                          (UB_C, 1)):
            out[:, :, col] = np.where(live, out[:, :, col] - b // unit,
                                      out[:, :, col])
    return out.astype(np.int32)

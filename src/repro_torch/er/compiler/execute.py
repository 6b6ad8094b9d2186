"""Execution: stage 1 (kernel cosine filter) over a lowered catalog —
on one device or on a device mesh — stage 2 (exact edit distance) on its
survivors, and the fused entry point.

Port of ``repro.er.compiler.execute``. ``score_catalog`` runs the catalog
through the CUDA catalog kernels on one device in fixed-size chunks
(padded to powers of two with all-zero entries, which keep nothing
because ``r0 == r1``) and decodes each chunk's packed survivors on the
host; a chunk whose EXACT count overflows the capacity is re-scored
through the dense-mask kernel. ``execute(mesh=...)`` scores per-device
tile shards through a :func:`make_scorer` data flow — self-join, cross
(b replicated) or the RepSN halo — with the flat, ring or hierarchical
gather of ``compiler.comms`` and an optional model axis (partial scores
psum-combined before the epilogue); one process drives every shard (see
:mod:`repro_torch.sharding`), each shard's kernel runs on the shard's
device, and every flow's bytes received per device land in
``stage1_stats["interconnect"]``. ``verify_pairs`` is stage 2 on the
device, ``match_catalog`` fuses the two. ``execute_supervised`` is the
fault-tolerant supervisor: tiles scheduled onto logical device shards,
each shard scored by ``score_catalog`` on the card, failed shards
re-scheduled tile by tile.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device, synchronize
from ...sharding import (Sharded, all_gather, ppermute, psum, replicate,
                         shard_rows)
from .. import trace
from .comms import (COMMS_POLICIES, CommsPlan, halo_bytes_per_device,
                    plan_comms, psum_bytes_per_device, rewrite_tiles_local)
from .faults import DeviceKilledError, FaultInjector, TransientScorerError
from .feedback import N_TILE_CLASSES, EwmaCostModel, tile_class
from .ir import A_TILE, B_TILE, NCOLS, TileCatalog
from .lower import pad_tiles
from .schedule import (NoHealthyDevicesError, Schedule, schedule_tiles,
                       tile_costs, tiles_for_devices)

__all__ = ["CatalogScorer", "execute", "execute_supervised", "make_scorer",
           "score_catalog", "stage1_stats", "stage2_stats", "verify_pairs",
           "match_catalog", "shard_sane", "ShardRecord", "SupervisedReport",
           "RecoveryFailedError"]


def _pad_pow2(t: int, cap: int) -> int:
    p = 1
    while p < t:
        p *= 2
    return min(p, cap)


# Host-side instrumentation of stage 1, accumulated over calls:
#   compact_decodes   — chunks decoded from the on-device packed epilogue
#   nonzero_decodes   — chunks decoded from the dense mask
#   compact_overflows — compact chunks whose exact counts exceeded the
#                       capacity, forcing the exact mask-path fallback
#   interconnect      — bytes RECEIVED per device, per data flow, summed
#                       over mesh launches (each launch re-runs its
#                       gather), from the exact formulas of
#                       ``compiler.comms``, as the JAX package counts them
stage1_stats: dict = {"compact_decodes": 0, "nonzero_decodes": 0,
                      "compact_overflows": 0,
                      "interconnect": {"flat_bytes": 0, "ring_bytes": 0,
                                       "hier_intra_bytes": 0,
                                       "hier_inter_bytes": 0,
                                       "halo_bytes": 0, "psum_bytes": 0}}


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _decode_packed(packed: np.ndarray, counts: np.ndarray,
                   chunk: np.ndarray, bm: int, bn: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Packed (T, ≥ max count) survivor slots + exact (T,) counts → global
    (rows_a, rows_b), O(survivors) host work — no scan of dead cells."""
    tot = int(counts.sum())
    if tot == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ti = np.repeat(np.arange(counts.size), counts)
    starts = np.cumsum(counts) - counts
    slot = np.arange(tot) - np.repeat(starts, counts)
    flat = packed[ti, slot].astype(np.int64)
    rows_a = chunk[ti, A_TILE].astype(np.int64) * bm + flat // bn
    rows_b = chunk[ti, B_TILE].astype(np.int64) * bn + flat % bn
    return rows_a, rows_b


def _decode_on_device(packed: torch.Tensor, counts: torch.Tensor,
                      tiles: torch.Tensor, tot: int, bm: int, bn: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`_decode_packed` on the tensors' device: packed (T, ≥ max
    count) slots, exact (T,) counts whose sum ``tot`` (> 0) the host
    already holds, (T, NCOLS) tiles → global (rows_a, rows_b), brought to
    the host in one copy."""
    dev = counts.device
    counts = counts.to(torch.int64)
    ti = torch.repeat_interleave(torch.arange(counts.numel(), device=dev),
                                 counts, output_size=tot)
    slot = (torch.arange(tot, device=dev)
            - (torch.cumsum(counts, 0) - counts)[ti])
    flat = packed[ti, slot].to(torch.int64)
    rows = torch.stack([tiles[ti, A_TILE].to(torch.int64) * bm + flat // bn,
                        tiles[ti, B_TILE].to(torch.int64) * bn + flat % bn])
    rows = rows.cpu().numpy()
    return rows[0], rows[1]


def _score_mask(fa, fb, chunk, chunk_t, *, threshold, bm, bn, impl, dev):
    """One chunk through the dense-mask kernel → global (rows_a, rows_b)."""
    from ...kernels import ops

    mask = ops.pair_scores_catalog(fa, fb, chunk_t, threshold=threshold,
                                   block_m=bm, block_n=bn, impl=impl)
    synchronize([dev])
    stage1_stats["nonzero_decodes"] += 1
    ti, ii, jj = (x.cpu().numpy() for x in torch.nonzero(mask, as_tuple=True))
    return (chunk[ti, A_TILE].astype(np.int64) * bm + ii,
            chunk[ti, B_TILE].astype(np.int64) * bn + jj)


# Packed survivor slots (bytes) launched before any of them is read back:
# a bound on stage 1's device memory, not a tuning knob.
_INFLIGHT_BYTES = 1 << 30


def _score_compact(fa, fb, group, *, threshold, bm, bn, capacity, impl,
                   dev) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Chunks through the compact kernel, every one launched before any is
    read: the exact counts of all come back in one copy, then the
    survivors, decoded on the device, in a second. A chunk whose count
    passes ``capacity`` is re-scored through the dense mask. One
    (rows_a, rows_b) per chunk, in order."""
    from ...kernels import ops

    launched = [ops.pair_scores_catalog_compact(
        fa, fb, chunk_t, threshold=threshold, block_m=bm, block_n=bn,
        capacity=capacity, impl=impl) for _, chunk_t in group]
    counts_t = torch.cat([c for _, c in launched]).reshape(-1)
    counts = counts_t.cpu().numpy().astype(np.int64)
    ends = np.cumsum([chunk.shape[0] for chunk, _ in group])
    per_chunk = np.split(counts, ends[:-1])
    kmax = [int(c.max(initial=0)) for c in per_chunk]
    good = [i for i, k in enumerate(kmax) if k <= capacity]
    stage1_stats["compact_decodes"] += len(good)
    totals = [int(per_chunk[i].sum()) for i in good]
    ra = rb = np.zeros(0, np.int64)
    if sum(totals):
        if len(good) < len(group):
            counts_t = torch.cat([counts_t[ends[i] - len(group[i][0]):ends[i]]
                                  for i in good])
        k = max(kmax[i] for i in good)
        with trace.span("stage1.decode"):
            ra, rb = _decode_on_device(
                torch.cat([launched[i][0][:, :k] for i in good]), counts_t,
                torch.cat([group[i][1] for i in good]), sum(totals), bm, bn)
    cuts = np.cumsum(totals)[:-1]
    out = [None] * len(group)
    for i, a, b in zip(good, np.split(ra, cuts), np.split(rb, cuts)):
        out[i] = (a, b)
    for i, chunk_out in enumerate(out):
        if chunk_out is None:
            # Exact counts flagged dropped survivors: re-score this chunk
            # through the dense mask (exactness over speed).
            stage1_stats["compact_overflows"] += 1
            chunk, chunk_t = group[i]
            out[i] = _score_mask(fa, fb, chunk, chunk_t, threshold=threshold,
                                 bm=bm, bn=bn, impl=impl, dev=dev)
    return out


def score_catalog(feats_a, catalog: TileCatalog, feats_b=None, *,
                  threshold: float, impl: str = "auto",
                  chunk_tiles: int = 1024, compact: bool = True,
                  compact_capacity: Optional[int] = None,
                  device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Stage 1 for a whole catalog on one device: survivor candidate pairs.

    Features (numpy or tensors) and the padded catalog move to ``device``
    once. With ``compact`` the kernel's epilogue packs each tile's
    survivors on the device; the chunks are launched in groups of up to
    ``_INFLIGHT_BYTES`` of packed slots, each group's exact counts come
    back in one copy, and its survivors are decoded on the device and
    come back in a second (O(survivors), no scan of dead cells).
    ``compact_capacity`` bounds the packed slots per tile (default bm·bn,
    which can never overflow); a chunk whose exact count exceeds it is
    re-scored through the dense mask — still exact, counted in
    ``stage1_stats['compact_overflows']``. Returns two int64 arrays, in
    chunk order.
    """
    dev = resolve_device(device)
    fa = _to_device(feats_a, dev)
    fb = fa if feats_b is None else _to_device(feats_b, dev)
    tiles = catalog.tiles
    bm, bn = catalog.block_m, catalog.block_n
    capacity = compact_capacity if compact_capacity is not None else bm * bn
    chunks = []
    for lo in range(0, tiles.shape[0], chunk_tiles):
        chunk = tiles[lo:lo + chunk_tiles]
        padded = _pad_pow2(chunk.shape[0], chunk_tiles)
        if padded != chunk.shape[0]:
            # Empty entries: zero windows (r0 == r1) mask everything out.
            pad = np.zeros((padded - chunk.shape[0], NCOLS), np.int32)
            chunk = np.concatenate([chunk, pad], axis=0)
        chunks.append(chunk)
    if not chunks:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    on_dev = torch.split(torch.from_numpy(np.ascontiguousarray(
        np.concatenate(chunks))).to(dev), [c.shape[0] for c in chunks])
    kw = dict(threshold=threshold, bm=bm, bn=bn, impl=impl, dev=dev)
    out, group, group_bytes = [], [], 0
    for chunk, chunk_t in zip(chunks, on_dev):
        if not compact:
            out.append(_score_mask(fa, fb, chunk, chunk_t, **kw))
            continue
        nbytes = chunk.shape[0] * capacity * 4
        if group and group_bytes + nbytes > _INFLIGHT_BYTES:
            out += _score_compact(fa, fb, group, capacity=capacity, **kw)
            group, group_bytes = [], 0
        group.append((chunk, chunk_t))
        group_bytes += nbytes
    if group:
        out += _score_compact(fa, fb, group, capacity=capacity, **kw)
    return (np.concatenate([a for a, _ in out]),
            np.concatenate([b for _, b in out]))


# ---------------------------------------------------------------------------
# Mesh stage 1
# ---------------------------------------------------------------------------

class CatalogScorer:
    """A per-shard catalog scorer bound to one device grid, plus the
    metadata :func:`_score_and_compact` needs to decode its output.
    ``compact`` scorers return per-shard ``(packed, counts)`` lists from
    the kernel's on-device compaction epilogue; mask scorers a list of
    per-shard dense survivor masks. Callable like the bare function, with
    a mask twin for the exact fallback on capacity overflow, built on
    first use."""

    def __init__(self, fn, *, grid: np.ndarray, compact: bool,
                 capacity: int, mask_factory):
        self._fn = fn
        self.grid = grid
        self.compact = compact
        self.capacity = capacity
        self._mask_factory = mask_factory
        self._mask_twin = None

    def __call__(self, *operands):
        return self._fn(*operands)

    def mask_twin(self) -> "CatalogScorer":
        """The dense-mask scorer with identical routing — built only if an
        overflow ever forces the exact fallback."""
        if self._mask_twin is None:
            self._mask_twin = self._mask_factory()
        return self._mask_twin


def _raw_to_mask(total, tiles, bm: int, bn: int, threshold: float):
    """Threshold + catalog-predicate epilogue on COMBINED tile scores —
    the post-psum half of the model-parallel path (partial scores cannot
    be thresholded; see ``ref.pair_scores_catalog_raw_ref``). The
    threshold is compared in f32, as the kernels compare it."""
    from ...kernels.pair_sim import catalog_tile_mask

    cat = tiles.to(torch.int64)
    dev = total.device
    gi = cat[:, 0, None, None] * bm + torch.arange(bm, device=dev)[:, None]
    gj = cat[:, 1, None, None] * bn + torch.arange(bn, device=dev)[None, :]
    entry = [cat[:, c, None, None] for c in range(NCOLS)]
    keep = (total >= float(np.float32(threshold))) & catalog_tile_mask(
        entry, gi, gj)
    return keep.to(torch.float32)


def make_scorer(mesh, axis: str = "data", *, mode: str = "self",
                threshold: float, block_m: int = 128, block_n: int = 128,
                impl: str = "auto", halo: int = 0, compact: bool = False,
                capacity: Optional[int] = None, comms: str = "flat",
                hops: int = 0, group: int = 1, inter_hops: int = 0,
                model_axis: Optional[str] = None) -> CatalogScorer:
    """Build ONE per-shard catalog scorer for the given data flow on
    ``mesh`` (a :class:`~repro_torch.sharding.Mesh`). One process drives
    every shard: the collectives of :mod:`repro_torch.sharding` move each
    gather's rows between the shards' devices, then every shard's kernel
    is launched on its own device before any result is read.

    mode="self":  scorer(feats, tiles_chunk)
    mode="cross": scorer(feats_a, feats_b, tiles_chunk) — b replicated
    mode="halo":  scorer(feats, tiles_chunk) — ⌈halo/n_loc⌉ chained
                  neighbor ppermute hops (full strips, then the final
                  ``take``-row prefix) instead of a gather; tiles index
                  the [local ‖ halo] strip and each shard receives
                  exactly ``halo`` rows.

    Features are :class:`~repro_torch.sharding.Sharded` (``feats`` row-
    sharded, ``feats_b`` replicated); ``tiles_chunk`` is the
    (n_data, chunk, NCOLS) int32 numpy array of per-shard tiles.

    ``comms`` selects the self/cross gather (``compiler.comms``): "flat"
    all-gathers; "ring" runs ``hops`` chained forward ppermutes,
    assembling the contiguous strip window [d·n_loc, d·n_loc +
    (hops+1)·n_loc) — tiles must be rewritten to that buffer's local
    coordinates and placed by the planner's locality rule; "hierarchical"
    assembles each ``group``-strip panel with an intra-group ring
    (restored to global row order by a roll by the shard's in-group
    rank), then exchanges whole panels over ``inter_hops``
    stride-``group`` hops.

    ``model_axis`` column-shards the features (d/n_model per device):
    each (data, model) shard computes *partial* tile scores with the raw
    op (K6, plain PyTorch), a psum over the model group combines them,
    and the threshold + predicate epilogue runs on the combined scores
    (packed post-psum by ``ref.pack_survivor_mask`` when ``compact``).
    The psum reassociates the d-dimensional dot, so a score within float
    ulps of the threshold can flip against the single-axis path; the
    data-axis policies reduce in the same order and are bit-exact.

    Without a model axis each shard runs the CUDA catalog kernels (K1
    with ``compact``, else K2) on its device — or their plain versions on
    CPU shards (``impl``, as :mod:`repro_torch.kernels.ops` resolves it).
    ``capacity`` defaults to bm·bn, which can never overflow.
    """
    from ...kernels import ops, ref

    cap = capacity if capacity is not None else block_m * block_n
    if comms not in COMMS_POLICIES:
        raise ValueError(f"unknown comms policy {comms!r}")
    if comms != "flat" and mode == "halo":
        raise ValueError("halo mode has its own neighbor exchange; "
                         "comms applies to self/cross gathers only")
    if mode not in ("self", "cross", "halo"):
        raise ValueError(f"unknown scorer mode {mode!r}")
    grid = mesh.grid(axis, model_axis)
    n_data, n_model = grid.shape
    perm_fwd = [(s, (s - 1) % n_data) for s in range(n_data)]

    def _chain(col, devs, perm, n_hops, take=None):
        """``n_hops`` chained ppermutes of ``col``; each position's parts
        in arrival order (its own first). ``take`` trims the last send."""
        parts, cur = [list(col)], list(col)
        for k in range(1, n_hops + 1):
            send = ([c[:take] for c in cur]
                    if take is not None and k == n_hops else cur)
            cur = ppermute(send, perm, devs)
            parts.append(cur)
        return [torch.cat([p[d] for p in parts], dim=0) if n_hops
                else col[d] for d in range(n_data)]

    def _gather(col, devs):
        if comms == "flat":
            return all_gather(col, devs)
        if comms == "ring":
            # Hop k delivers strip d+k; the buffer is the contiguous
            # global row window starting at this shard's own strip.
            return _chain(col, devs, perm_fwd, hops)
        g = group
        n_loc = col[0].shape[0]
        perm_intra = [(s, (s // g) * g + ((s % g) - 1) % g)
                      for s in range(n_data)]
        perm_inter = [(s, (s - g) % n_data) for s in range(n_data)]
        panels = _chain(col, devs, perm_intra, g - 1)
        # Shard G·g+p assembled [strip p, p+1, … (group-relative,
        # wrapped)]; a roll by its in-group rank restores global row
        # order, so the panel is one contiguous window for every member.
        panels = [torch.roll(pn, (d % g) * n_loc, dims=0) if g > 1 else pn
                  for d, pn in enumerate(panels)]
        return _chain(panels, devs, perm_inter, inter_hops)

    def _halo(col, devs):
        if not halo:
            return list(col)
        n_loc = col[0].shape[0]
        k_hops = -(-halo // n_loc)
        # Before hop k each shard holds strip d+k−1 and forwards it; the
        # LAST hop sends only the ``take``-row prefix, so each shard
        # receives exactly halo rows.
        return _chain(col, devs, perm_fwd, k_hops,
                      take=halo - (k_hops - 1) * n_loc)

    def _score(a, b, tiles_t):
        kw = dict(threshold=threshold, block_m=block_m, block_n=block_n,
                  impl=impl)
        if compact:
            return ops.pair_scores_catalog_compact(a, b, tiles_t,
                                                   capacity=cap, **kw)
        return ops.pair_scores_catalog(a, b, tiles_t, **kw)

    def job2(*args):
        *operands, tiles_chunk = args
        feats = operands[0]
        tiles = [[torch.from_numpy(np.ascontiguousarray(tiles_chunk[d]))
                  .to(grid[d, m], non_blocking=True) for m in range(n_model)]
                 for d in range(n_data)]
        a_cols, b_cols = [], []
        for m in range(n_model):
            devs = list(grid[:, m])
            bufs = (_halo if mode == "halo" else _gather)(feats.column(m),
                                                          devs)
            a_cols.append(bufs)
            b_cols.append(operands[1].column(m) if mode == "cross" else bufs)
        out = []
        for d in range(n_data):
            if model_axis is None:
                out.append(_score(a_cols[0][d], b_cols[0][d], tiles[d][0]))
                continue
            raw = [ops.pair_scores_catalog_raw(
                a_cols[m][d], b_cols[m][d], tiles[d][m], block_m=block_m,
                block_n=block_n, impl=impl) for m in range(n_model)]
            total = psum(raw, list(grid[d]))[0]
            mask = _raw_to_mask(total, tiles[d][0], block_m, block_n,
                                threshold)
            out.append(ref.pack_survivor_mask(mask, cap) if compact
                       else mask)
        if compact:
            return [o[0] for o in out], [o[1] for o in out]
        return out

    def mask_factory():
        return make_scorer(mesh, axis, mode=mode, threshold=threshold,
                           block_m=block_m, block_n=block_n, impl=impl,
                           halo=halo, compact=False, comms=comms, hops=hops,
                           group=group, inter_hops=inter_hops,
                           model_axis=model_axis)

    return CatalogScorer(job2, grid=grid, compact=compact, capacity=cap,
                         mask_factory=mask_factory)


def _mesh_operands(grid: np.ndarray, feats_a, feats_b=None) -> tuple:
    """The scorer's operands: ``feats_a`` row-sharded and ``feats_b``
    replicated over ``grid`` (already :class:`Sharded` ones as they are)."""
    fa = feats_a if isinstance(feats_a, Sharded) else shard_rows(feats_a,
                                                                 grid)
    if feats_b is None:
        return (fa,)
    fb = feats_b if isinstance(feats_b, Sharded) else replicate(feats_b,
                                                                grid)
    return fa, fb


def _score_and_compact(shard, operands, tiles_dev, chunk: int,
                       bm: int, bn: int,
                       base_a: Optional[np.ndarray] = None,
                       base_b: Optional[np.ndarray] = None,
                       launch_flows=None) -> Tuple[np.ndarray, np.ndarray]:
    """Drive a :class:`CatalogScorer` chunk by chunk and compact each
    chunk's output into global (rows_a, rows_b).

    Every shard's kernel is launched before any count is read back; a
    compact chunk then copies each shard's exact counts and the first
    ``max(count)`` packed slots of its tiles to the host and decodes them
    in O(survivors). A chunk whose exact count exceeds the capacity
    re-scores through the mask twin, exactness over speed. Both paths
    are counted in ``stage1_stats``. ``base_a``/``base_b`` (n_dev,) shift
    device-local tile coordinates to global rows on each side (the RepSN and
    ring/hierarchical local-coordinate paths; cross-mode ring shifts the
    a-side only); None means that side's tiles carry global strip
    indices. ``launch_flows(chunk_size) -> {flow: bytes}`` is called once
    per scorer invocation (mask-twin refires included — every invocation
    re-runs its gather) and accumulated into
    ``stage1_stats["interconnect"]``."""
    cap = tiles_dev.shape[1]
    is_compact = getattr(shard, "compact", False)
    devices = list(shard.grid.flat)
    out_a, out_b = [], []

    def _account(csize: int) -> None:
        if launch_flows is None:
            return
        acc = stage1_stats["interconnect"]
        for k, v in launch_flows(csize).items():
            acc[k] = acc.get(k, 0) + v

    def _offsets(dd):
        return (base_a[dd] if base_a is not None else 0,
                base_b[dd] if base_b is not None else 0)

    for lo in range(0, cap, chunk):
        part = tiles_dev[:, lo:lo + chunk]
        masks = None
        if is_compact:
            _account(part.shape[1])
            packed, counts = shard(*operands, part)
            counts = np.stack([c.reshape(-1).cpu().numpy()
                               for c in counts]).astype(np.int64)
            if counts.max(initial=0) <= shard.capacity:
                stage1_stats["compact_decodes"] += 1
                for dd in range(part.shape[0]):
                    kmax = int(counts[dd].max(initial=0))
                    ra, rb = _decode_packed(
                        packed[dd][:, :kmax].cpu().numpy(), counts[dd],
                        part[dd], bm, bn)
                    off_a, off_b = _offsets(dd)
                    out_a.append(off_a + ra)
                    out_b.append(off_b + rb)
                continue
            stage1_stats["compact_overflows"] += 1
            _account(part.shape[1])
            masks = shard.mask_twin()(*operands, part)
        if masks is None:
            _account(part.shape[1])
            masks = shard(*operands, part)
        synchronize(devices)
        stage1_stats["nonzero_decodes"] += 1
        for dd, mask in enumerate(masks):
            ti, ii, jj = (x.cpu().numpy()
                          for x in torch.nonzero(mask, as_tuple=True))
            off_a, off_b = _offsets(dd)
            out_a.append(off_a + part[dd, ti, A_TILE].astype(np.int64) * bm
                         + ii)
            out_b.append(off_b + part[dd, ti, B_TILE].astype(np.int64) * bn
                         + jj)
    if not out_a:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(out_a), np.concatenate(out_b)


def _tiles_by_device(catalog: TileCatalog, n_dev: int,
                     device_of: np.ndarray) -> np.ndarray:
    """(n_dev, cap, NCOLS) tile shards from an explicit placement (the
    comms planner's locality rule), zero-padded like
    :func:`tiles_for_devices` (empty windows mask everything out)."""
    counts = np.bincount(device_of, minlength=n_dev)
    cap = max(int(counts.max(initial=0)), 1)
    out = np.zeros((n_dev, cap, NCOLS), np.int32)
    for d in range(n_dev):
        mine = catalog.tiles[device_of == d]
        out[d, :mine.shape[0]] = mine
    return out


def _launch_flows_factory(plan: Optional[CommsPlan], halo: int,
                          n_data: int, n_model: int, n_rows: int,
                          feature_dim: int, bm: int, bn: int):
    """Per-launch interconnect accounting for :func:`_score_and_compact`:
    ``flows(chunk_size) -> {flow: bytes received per device}``, mirroring
    ``compiler.comms`` exactly (the gather/halo flows are launch-size
    independent; the psum payload is the launched tile count)."""
    if n_data <= 1 and n_model <= 1:
        return None
    n_loc = -(-n_rows // n_data)
    d_loc = feature_dim // max(n_model, 1)

    def flows(csize: int) -> dict:
        out = {}
        if halo:
            out["halo_bytes"] = sum(
                halo_bytes_per_device(n_loc, halo, d_loc))
        elif plan is not None and plan.policy == "ring":
            out["ring_bytes"] = plan.hops * n_loc * d_loc * plan.itemsize
        elif plan is not None and plan.policy == "hierarchical":
            row = d_loc * plan.itemsize
            out["hier_intra_bytes"] = (plan.group - 1) * n_loc * row
            out["hier_inter_bytes"] = (plan.inter_hops * plan.group
                                       * n_loc * row)
        elif n_data > 1:
            out["flat_bytes"] = (n_data - 1) * n_loc * d_loc * 4
        if n_model > 1:
            out["psum_bytes"] = psum_bytes_per_device(n_model, csize, bm, bn)
        return out

    return flows


def execute(catalog: TileCatalog, feats_a, feats_b=None, *,
            threshold: float, impl: str = "auto", mesh=None,
            axis: str = "data", chunk_tiles: int = 1024,
            schedule: Optional[Schedule] = None,
            healthy: Optional[np.ndarray] = None,
            scorer: Optional[CatalogScorer] = None,
            fixed_chunks: bool = False, halo: int = 0,
            base: Optional[np.ndarray] = None, compact: bool = True,
            compact_capacity: Optional[int] = None, comms: str = "flat",
            comms_plan: Optional[CommsPlan] = None,
            model_axis: Optional[str] = None,
            device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Stage 1 of ANY lowered catalog: compacted survivor candidates.

    Single device (``mesh=None``): chunked :func:`score_catalog` on
    ``device`` (comms and model_axis are mesh concepts and are ignored).
    On a mesh (:class:`~repro_torch.sharding.Mesh`; ``device`` is not
    read — the mesh names its devices): tiles route to devices via the
    :class:`Schedule` (cost-LPT placement) or round-robin when none is
    given, and each device scores its shard through a
    :func:`make_scorer` data flow — "self" when ``feats_b`` is None,
    "cross" when it is given (b replicated), "halo" when ``halo > 0``
    (RepSN boundary replication; implies self-join, ``base`` shifts local
    survivor coordinates to global rows; any window size). Features are
    numpy, tensors or already :class:`~repro_torch.sharding.Sharded`; the
    a-side's rows must divide over the data axis (and its columns over
    the model axis).

    ``comms`` swaps the flat all-gather for the ring / hierarchical
    strip exchange: the plan (``comms_plan`` > ``schedule.comms`` >
    freshly planned from the catalog) carries the locality tile
    placement, hop counts and buffer origins; tiles are rewritten to
    buffer-local coordinates and the plan's ``base`` shifts survivors
    back (a-side only in cross mode). A plan that degraded to flat
    (``plan.fallback``) runs the flat path. Requires every device
    healthy — locality placement has no failover. ``model_axis`` adds
    the second mesh axis: features column-sharded d/n_model, partial
    scores psum-combined in the scorer. Interconnect bytes per flow
    accumulate in ``stage1_stats["interconnect"]``, from the comms
    formulas.

    ``fixed_chunks=True`` pads every device shard UP to a ``chunk_tiles``
    multiple, so each launch has the shape (n_dev, chunk_tiles, NCOLS) —
    the resident service's fixed shapes; the default shrinks the chunk
    to the largest shard (still >= one all-zero tile) for one-shot jobs.
    Pass ``scorer=`` to reuse a prebuilt :func:`make_scorer`; with
    ``comms_plan`` its pinned hop count must cover the plan's (extra
    gathered strips are never referenced, so over-gathering is exact).

    Returns host int64 (rows_a, rows_b); run stage 2 via
    :func:`verify_pairs`.
    """
    if mesh is None:
        return score_catalog(feats_a, catalog, feats_b,
                             threshold=threshold, impl=impl,
                             chunk_tiles=chunk_tiles, compact=compact,
                             compact_capacity=compact_capacity, device=device)
    n_data = int(mesh.shape[axis])
    n_model = int(mesh.shape[model_axis]) if model_axis else 1
    bm, bn = catalog.block_m, catalog.block_n
    n_rows = int(feats_a.shape[0])
    feature_dim = int(feats_a.shape[1])

    plan = comms_plan
    if plan is None and schedule is not None:
        plan = getattr(schedule, "comms", None)
    if plan is None and comms != "flat":
        if halo:
            raise ValueError("halo mode has its own neighbor exchange; "
                             "comms must stay 'flat'")
        if healthy is not None and not bool(np.all(healthy)):
            raise ValueError("comms != 'flat' requires all devices healthy "
                             "(locality placement has no failover); run "
                             "degraded jobs with comms='flat'")
        plan = plan_comms(catalog, n_rows, n_data, policy=comms,
                          n_model=n_model, feature_dim=feature_dim,
                          self_join=feats_b is None)

    ring_like = plan is not None and plan.policy != "flat"
    if ring_like:
        tiles_dev = _tiles_by_device(catalog, n_data, plan.device_of_tile)
    else:
        tiles_dev = tiles_for_devices(catalog, n_data, healthy, schedule)
    if fixed_chunks:
        chunk = chunk_tiles
    else:
        chunk = min(chunk_tiles, max(tiles_dev.shape[1], 1))
    tiles_dev = pad_tiles(tiles_dev, chunk)
    base_a = base_b = base
    if ring_like:
        tiles_dev = rewrite_tiles_local(tiles_dev, plan.base, bm, bn,
                                        shift_b=feats_b is None)
        base_a = plan.base
        base_b = plan.base if feats_b is None else None
    if scorer is None:
        mode = "halo" if halo > 0 else ("cross" if feats_b is not None
                                        else "self")
        scorer = make_scorer(mesh, axis, mode=mode, threshold=threshold,
                             block_m=bm, block_n=bn, impl=impl, halo=halo,
                             compact=compact, capacity=compact_capacity,
                             comms=plan.policy if plan is not None else "flat",
                             hops=plan.hops if plan is not None else 0,
                             group=plan.group if plan is not None else 1,
                             inter_hops=(plan.inter_hops
                                         if plan is not None else 0),
                             model_axis=model_axis)
    operands = _mesh_operands(scorer.grid, feats_a, feats_b)
    flows = _launch_flows_factory(plan, halo, n_data, n_model, n_rows,
                                  feature_dim, bm, bn)
    return _score_and_compact(scorer, operands, tiles_dev, chunk, bm, bn,
                              base_a=base_a, base_b=base_b,
                              launch_flows=flows)


# ---------------------------------------------------------------------------
# Supervised stage 1: tile-granular fault recovery
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardRecord:
    """One per-device-shard completion record, the supervisor's ledger."""
    round: int
    device: int
    tiles: int
    cost: int                  # live pairs the shard was responsible for
    status: str                # ok | killed | transient | timeout | corrupt
    elapsed: float             # REAL wall seconds of the shard call
    injected_delay: float = 0.0  # virtual straggle seconds (injector only)

    @property
    def busy(self) -> float:
        """Simulated device-busy seconds: real wall time plus the
        injected virtual delay. Deadlines, the makespan clock and the
        feedback model run on busy time; latency *statistics* must use
        ``elapsed`` so chaos scripts don't poison them."""
        return self.elapsed + self.injected_delay


@dataclass
class SupervisedReport:
    """What happened during one :func:`execute_supervised` run."""
    rounds: int = 0            # scheduling rounds executed (1 == quiet run)
    recovered_tiles: int = 0   # tiles that succeeded on a retry round
    planned_cost: int = 0      # live pairs the catalog plans
    scored_cost: int = 0       # live pairs covered by accepted shards
    lost_tiles: int = 0        # tiles never scored (degraded mode only)
    steals: int = 0            # mid-stream re-LPT events (slow devices)
    stolen_tiles: int = 0      # queued tiles moved off slow devices
    predicted_makespan_s: float = 0.0  # calibrated round-1 projection
    measured_makespan_s: float = 0.0   # Σ rounds max device busy-time
    records: List[ShardRecord] = field(default_factory=list)
    backoffs: List[float] = field(default_factory=list)
    healthy: Optional[np.ndarray] = None   # final device mask

    @property
    def retries(self) -> int:
        return max(self.rounds - 1, 0)

    @property
    def coverage(self) -> float:
        """Fraction of planned live pairs actually scored — 1.0 after a
        full recovery, < 1.0 only in degraded (partial) mode."""
        if self.planned_cost == 0:
            return 1.0
        return self.scored_cost / self.planned_cost


class RecoveryFailedError(RuntimeError):
    """Retries/deadline exhausted with tiles still unscored (and the
    caller did not opt into partial results). Carries the report."""

    def __init__(self, msg: str, report: SupervisedReport):
        super().__init__(msg)
        self.report = report


def shard_sane(rows_a: np.ndarray, rows_b: np.ndarray,
               n_a: int, n_b: int) -> bool:
    """Cheap survivor sanity check: paired 1-D int arrays, every index in
    bounds. Any corrupted shard from :meth:`FaultInjector.corrupt_output`
    fails this by construction; a real deployment would run the same
    check on rows coming back over the wire."""
    if rows_a.shape != rows_b.shape or rows_a.ndim != 1:
        return False
    if rows_a.size == 0:
        return True
    return bool((rows_a >= 0).all() and (rows_a < n_a).all()
                and (rows_b >= 0).all() and (rows_b < n_b).all())


def _sub_catalog(catalog: TileCatalog, idx: np.ndarray) -> TileCatalog:
    return TileCatalog(tiles=catalog.tiles[idx], block_m=catalog.block_m,
                       block_n=catalog.block_n, n_rows_a=catalog.n_rows_a,
                       n_rows_b=catalog.n_rows_b, r=catalog.r,
                       total_pairs=catalog.total_pairs)


def execute_supervised(catalog: TileCatalog, feats_a, feats_b=None, *,
                       threshold: float, n_dev: int = 1,
                       healthy: Optional[np.ndarray] = None,
                       impl: str = "auto", chunk_tiles: int = 1024,
                       policy: str = "cost_lpt",
                       injector: Optional[FaultInjector] = None,
                       shard_deadline: Optional[float] = None,
                       deadline: Optional[float] = None,
                       max_retries: int = 3, backoff: float = 0.05,
                       backoff_factor: float = 2.0, sleep=time.sleep,
                       partial: bool = False,
                       feedback: Optional[EwmaCostModel] = None,
                       steal_factor: Optional[float] = None,
                       steal_quantum: Optional[int] = None,
                       compact: bool = True,
                       compact_capacity: Optional[int] = None,
                       device="cuda"
                       ) -> Tuple[np.ndarray, np.ndarray, SupervisedReport]:
    """Stage 1 with tile-granular fault recovery over logical devices.

    The catalog's tiles are cost-LPT scheduled onto ``n_dev`` logical
    device shards; the host drives each shard through
    :func:`score_catalog` on ``device`` (on a real cluster each shard
    call is the per-device RPC). Features move to ``device`` once; each
    shard's time ends when its survivors are on the host, so a shard's
    ``perf_counter`` time is device time plus the host decode. Every
    shard produces a completion record; shards that fail (killed
    device), time out (wall + injected latency > ``shard_deadline``),
    raise transiently, or return survivors that fail
    :func:`shard_sane` are DISCARDED, their device is masked out
    where the failure indicates device loss (kill/timeout), and ONLY the
    lost tiles are re-scheduled over the shrunken healthy mask — at most
    ``max_retries`` extra rounds with exponential backoff
    (``backoff * backoff_factor**k``, each sleep clamped to the
    remaining wall ``deadline``).

    **Runtime feedback.** Pass ``feedback=`` (an :class:`EwmaCostModel`)
    and every accepted shard call trains the model, and every round's
    ``schedule_tiles`` is calibrated by it (wall-clock-weighted tile
    packing, heterogeneous device placement). Pass ``steal_factor=`` to
    enable mid-stream work stealing: each device's round work is split
    into ``steal_quantum``-tile batches (one batch per device when
    unset), dispatch follows per-device virtual busy-time clocks (the
    idle-device-next simulation of a parallel fleet), and after every
    completed call a device whose projected finish exceeds
    ``steal_factor ×`` the fleet's median projection has its *queued*
    (never in-flight) batches re-placed greedily onto the
    fastest-projected other devices. Stolen tiles were not yet scored,
    so exactly-once merging is untouched.

    Survivors merge idempotently: the catalog covers each planned pair
    exactly once and results from failed shards are never merged, so
    re-executing a tile cannot double-count — the final
    ``np.unique`` over (row_a, row_b) makes recovery exactly-once at the
    match-set level even if a future policy merges late stragglers.

    ``deadline`` bounds the whole call (seconds); on exhaustion —
    or when retries run out, or every device dies — the call either
    raises :class:`RecoveryFailedError` / :class:`NoHealthyDevicesError`
    or, with ``partial=True``, returns what it has with
    ``report.coverage < 1`` (the service's graceful-degradation mode).

    Returns ``(rows_a, rows_b, report)`` — deduplicated host int64
    survivor candidates plus the :class:`SupervisedReport`.
    """
    t_start = time.perf_counter()
    dev = resolve_device(device)
    feats_a = _to_device(feats_a, dev)
    if feats_b is not None:
        feats_b = _to_device(feats_b, dev)
    if healthy is None:
        healthy = np.ones(n_dev, bool)
    healthy = np.asarray(healthy, bool).copy()
    if steal_factor is not None and feedback is None:
        feedback = EwmaCostModel(n_dev)
    costs = tile_costs(catalog)
    classes = tile_class(catalog) if feedback is not None else None
    report = SupervisedReport(planned_cost=int(costs.sum()), healthy=healthy)
    out_a: List[np.ndarray] = [np.zeros(0, np.int64)]
    out_b: List[np.ndarray] = [np.zeros(0, np.int64)]
    pending = np.arange(catalog.num_tiles, dtype=np.int64)
    n_a, n_b = catalog.n_rows_a, catalog.n_rows_b

    def _out_of_time() -> bool:
        return (deadline is not None
                and time.perf_counter() - t_start >= deadline)

    def _predict(dev: int, batch: np.ndarray) -> float:
        return feedback.predict_tiles(dev, costs[batch], classes[batch])

    def _steal_pass(queues, clocks) -> None:
        """Re-place every queued batch of over-projected devices onto the
        fastest-projected peers (greedy, largest batch first)."""
        proj = {}
        for k in clocks:
            proj[k] = clocks[k] + sum(_predict(k, b)
                                      for b in queues.get(k, ()))
        med = float(np.median(list(proj.values())))
        victims = [k for k in list(queues)
                   if proj[k] > steal_factor * max(med, 1e-9)]
        for v in victims:
            if len(clocks) < 2:
                return
            batches = queues.pop(v)
            report.steals += 1
            proj[v] = clocks[v]
            batches.sort(key=lambda b: -float(costs[b].sum()))
            for b in batches:
                dst = min((k for k in clocks if k != v),
                          key=lambda k: (proj[k] + _predict(k, b), k))
                queues.setdefault(dst, []).append(b)
                proj[dst] += _predict(dst, b)
                report.stolen_tiles += int(b.size)

    while pending.size:
        if report.rounds > max_retries or _out_of_time():
            break
        if report.rounds:                       # retry round: back off
            b = backoff * backoff_factor ** (report.rounds - 1)
            if deadline is not None:            # never sleep past deadline
                b = min(b, max(deadline - (time.perf_counter() - t_start),
                               0.0))
            report.backoffs.append(b)
            if b > 0:
                sleep(b)
            if _out_of_time():                  # re-check: sleep spent it
                break
        report.rounds += 1
        sub = _sub_catalog(catalog, pending)
        try:
            sched = schedule_tiles(sub, n_dev=n_dev, healthy=healthy,
                                   policy=policy, feedback=feedback)
        except NoHealthyDevicesError:
            if partial:
                break
            report.lost_tiles = int(pending.size)
            raise
        if report.rounds == 1 and sched.calibrated:
            report.predicted_makespan_s = float(np.max(sched.predicted_s))
        dev_of_tile = sched.reducer_device[sched.tile_reducer]
        lost: List[np.ndarray] = []
        # Per-device FIFO queues of quantum-sized batches plus virtual
        # busy-time clocks; dispatching to the min-clock device (lowest
        # id on ties) simulates a parallel fleet — with one batch per
        # device and zeroed clocks it reproduces the classic ascending-
        # device-order call sequence exactly.
        queues: dict = {}
        clocks: dict = {}
        for d in np.flatnonzero(healthy):
            d = int(d)
            clocks[d] = 0.0
            mine = pending[dev_of_tile == d]
            if mine.size == 0:
                continue
            if steal_quantum:
                queues[d] = [mine[lo:lo + steal_quantum]
                             for lo in range(0, mine.size, steal_quantum)]
            else:
                queues[d] = [mine]
        round_makespan = 0.0
        while queues:
            if _out_of_time():
                for q in queues.values():
                    lost.extend(q)
                queues.clear()
                break
            d = min(queues, key=lambda k: (clocks[k], k))
            mine = queues[d].pop(0)
            if not queues[d]:
                del queues[d]
            cost = int(costs[mine].sum())
            t0 = time.perf_counter()
            status, extra = "ok", 0.0
            ra = rb = None
            try:
                plan = injector.shard_call(d) if injector else None
                ra, rb = score_catalog(
                    feats_a, _sub_catalog(catalog, mine), feats_b,
                    threshold=threshold, impl=impl,
                    chunk_tiles=chunk_tiles, compact=compact,
                    compact_capacity=compact_capacity, device=dev)
                if plan is not None:
                    extra = plan.delay
                    if plan.corrupt:
                        ra, rb = injector.corrupt_output(ra, rb, n_a, n_b)
            except DeviceKilledError:
                status = "killed"
            except TransientScorerError:
                status = "transient"
            elapsed = time.perf_counter() - t0
            busy = elapsed + extra
            if status == "ok":
                if shard_deadline is not None and busy > shard_deadline:
                    status = "timeout"          # straggler: discard output
                elif not shard_sane(ra, rb, n_a, n_b):
                    status = "corrupt"          # failed the sanity check
            report.records.append(ShardRecord(
                round=report.rounds, device=d, tiles=int(mine.size),
                cost=cost, status=status, elapsed=elapsed,
                injected_delay=extra))
            clocks[d] += busy
            round_makespan = max(round_makespan, clocks[d])
            if status == "ok":
                out_a.append(ra)
                out_b.append(rb)
                report.scored_cost += cost
                if report.rounds > 1:
                    report.recovered_tiles += int(mine.size)
                if feedback is not None and cost > 0:
                    feedback.observe(
                        d, np.bincount(classes[mine], weights=costs[mine],
                                       minlength=N_TILE_CLASSES), busy)
            else:
                lost.append(mine)
                if status in ("killed", "timeout"):
                    healthy[d] = False          # device-level failure
                    lost.extend(queues.pop(d, []))
                    clocks.pop(d, None)
            if (steal_factor is not None and feedback is not None
                    and feedback.observations >= 1
                    and queues and len(clocks) > 1):
                _steal_pass(queues, clocks)
        report.measured_makespan_s += round_makespan
        pending = (np.concatenate(lost) if lost
                   else np.zeros(0, np.int64))

    report.lost_tiles = int(pending.size)
    report.healthy = healthy
    if pending.size and not partial:
        raise RecoveryFailedError(
            f"{pending.size} tiles unscored after {report.retries} retries",
            report)
    ra = np.concatenate(out_a)
    rb = np.concatenate(out_b)
    if ra.size:                                 # exactly-once at the
        pairs = np.unique(np.stack([ra, rb], axis=1), axis=0)   # match level
        ra, rb = pairs[:, 0], pairs[:, 1]
    return ra, rb, report


_VERIFY_CHUNK = 8_192

# Host-side instrumentation of stage 2, accumulated over calls: calls of
# :func:`verify_pairs` and the pairs they verified, on the CUDA kernel
# route (``kernels/edit_distance.py``, one launch a call) and on the plain
# route (``similarity.edit_similarity``, chunked).
stage2_stats: dict = {"kernel_calls": 0, "kernel_pairs": 0,
                      "plain_calls": 0, "plain_pairs": 0}


def verify_pairs(codes_a, lens_a, codes_b, lens_b, rows_a, rows_b,
                 threshold: float, chunk: int = _VERIFY_CHUNK,
                 device="cuda", impl: str = "auto"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Stage 2: exact normalized edit similarity >= threshold on candidate
    row pairs on ``device``. Codes and lengths (numpy or tensors) move to
    the device once; the similarities come back as f32 and are compared
    with the threshold on the host, as in the JAX package.

    ``impl`` as :func:`repro_torch.kernels.ops.resolve_impl` resolves it
    for ``device``: on the CUDA route every pair goes through one launch of
    the bit-vector kernel (one upload of the row indices, one copy of the
    similarities back); on the plain route the PyTorch DP loop runs in
    chunks of ``chunk`` pairs. Both give the same f32 similarities, bit for
    bit, so the same pairs."""
    from ...kernels import edit_distance, ops
    from ..similarity import edit_similarity

    dev = resolve_device(device)
    route = ops.resolve_impl(impl, dev)
    ca, la = _to_device(codes_a, dev), _to_device(lens_a, dev)
    if codes_b is codes_a and lens_b is lens_a:
        cb, lb = ca, la
    else:
        cb, lb = _to_device(codes_b, dev), _to_device(lens_b, dev)
    rows_a = np.asarray(rows_a, np.int64)
    rows_b = np.asarray(rows_b, np.int64)
    n_pairs = int(rows_a.shape[0])
    if route == "cuda":
        stage2_stats["kernel_calls"] += 1
        stage2_stats["kernel_pairs"] += n_pairs
        if n_pairs == 0:
            return rows_a[:0], rows_b[:0]
        for rows, n, side in ((rows_a, ca.shape[0], "a"),
                              (rows_b, cb.shape[0], "b")):
            if rows.min() < 0 or rows.max() >= n:
                raise IndexError(f"rows_{side} out of range for {n} rows")
        rows = torch.from_numpy(np.stack([rows_a, rows_b])).to(ca.device)
        sim = edit_distance.edit_similarity_rows(
            ca, la.to(torch.int32), cb, lb.to(torch.int32), rows[0],
            rows[1]).cpu().numpy()
        sel = np.flatnonzero(sim >= threshold)
        return rows_a[sel], rows_b[sel]
    stage2_stats["plain_calls"] += 1
    stage2_stats["plain_pairs"] += n_pairs
    hit_a, hit_b = [], []
    for lo in range(0, n_pairs, chunk):
        a = rows_a[lo:lo + chunk]
        b = rows_b[lo:lo + chunk]
        ia = torch.from_numpy(a).to(dev)
        ib = torch.from_numpy(b).to(dev)
        sim = edit_similarity(ca[ia], la[ia], cb[ib], lb[ib]).cpu().numpy()
        sel = np.flatnonzero(sim >= threshold)
        hit_a.append(a[sel])
        hit_b.append(b[sel])
    if not hit_a:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(hit_a), np.concatenate(hit_b)


def match_catalog(catalog: TileCatalog, feats_a, codes_a, lens_a, *,
                  feats_b=None, codes_b=None, lens_b=None,
                  threshold: float = 0.8, filter_margin: float = 0.25,
                  impl: str = "auto", mesh=None, axis: str = "data",
                  schedule: Optional[Schedule] = None,
                  chunk_tiles: int = 1024,
                  compact_capacity: Optional[int] = None,
                  comms: str = "flat",
                  comms_plan: Optional[CommsPlan] = None,
                  model_axis: Optional[str] = None,
                  device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Fused filter-and-verify: kernel stage 1 over the tile catalog,
    exact stage 2 on its survivors. Returns matched (rows_a, rows_b) —
    indices into the a-side (and b-side, if distinct) arrays.
    ``axis``/``schedule``/``comms``/``comms_plan``/``model_axis`` pass
    through to :func:`execute` (mesh runs only); on a mesh stage 2 runs
    on the mesh's first device."""
    cand_a, cand_b = execute(
        catalog, feats_a, feats_b, threshold=threshold - filter_margin,
        impl=impl, mesh=mesh, axis=axis, schedule=schedule,
        chunk_tiles=chunk_tiles, compact_capacity=compact_capacity,
        comms=comms, comms_plan=comms_plan, model_axis=model_axis,
        device=device)
    if codes_b is None:
        codes_b, lens_b = codes_a, lens_a
    return verify_pairs(codes_a, lens_a, codes_b, lens_b, cand_a, cand_b,
                        threshold,
                        device=mesh.first_device if mesh is not None
                        else device, impl=impl)

"""Execution, single host: stage 1 (kernel cosine filter) over a lowered
catalog, stage 2 (exact edit distance) on its survivors, and the fused
entry point.

Port of the single-host half of ``repro.er.compiler.execute``:
``score_catalog`` runs the catalog through the CUDA catalog kernels in
fixed-size chunks (padded to powers of two with all-zero entries, which
keep nothing because ``r0 == r1``) and decodes each chunk's packed
survivors on the host; a chunk whose EXACT count overflows the capacity
is re-scored through the dense-mask kernel. ``verify_pairs`` is stage 2
on the device, ``match_catalog`` fuses the two. The mesh and supervised
paths belong to later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from .ir import A_TILE, B_TILE, NCOLS, TileCatalog

__all__ = ["execute", "score_catalog", "stage1_stats", "verify_pairs",
           "match_catalog"]


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
#   kernel_seconds    — wall time from launch until the counts (or the
#                       mask) are ready on the device
#   decode_seconds    — device→host copy of the survivors + host decode
stage1_stats: dict = {"compact_decodes": 0, "nonzero_decodes": 0,
                      "compact_overflows": 0, "kernel_seconds": 0.0,
                      "decode_seconds": 0.0}


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def score_catalog(feats_a, catalog: TileCatalog, feats_b=None, *,
                  threshold: float, impl: str = "auto",
                  chunk_tiles: int = 1024, compact: bool = True,
                  compact_capacity: Optional[int] = None,
                  device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Stage 1 for a whole catalog on one device: survivor candidate pairs.

    Features (numpy or tensors) move to ``device`` once. With ``compact``
    the kernel's epilogue packs each tile's survivors on the device; only
    the exact counts and the first ``max(count)`` slots of each tile come
    back to the host, and the decode is O(survivors). ``compact_capacity``
    bounds the packed slots per tile (default bm·bn, which can never
    overflow); a chunk whose exact count exceeds it is re-scored through
    the dense mask — still exact, counted in
    ``stage1_stats['compact_overflows']``. Returns two int64 arrays.
    """
    from ...kernels import ops

    dev = resolve_device(device)
    fa = _to_device(feats_a, dev)
    fb = fa if feats_b is None else _to_device(feats_b, dev)
    tiles = catalog.tiles
    bm, bn = catalog.block_m, catalog.block_n
    capacity = compact_capacity if compact_capacity is not None else bm * bn
    out_a, out_b = [], []
    for lo in range(0, tiles.shape[0], chunk_tiles):
        chunk = tiles[lo:lo + chunk_tiles]
        padded = _pad_pow2(chunk.shape[0], chunk_tiles)
        if padded != chunk.shape[0]:
            # Empty entries: zero windows (r0 == r1) mask everything out.
            pad = np.zeros((padded - chunk.shape[0], NCOLS), np.int32)
            chunk = np.concatenate([chunk, pad], axis=0)
        chunk_t = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev)
        if compact:
            t0 = time.perf_counter()
            packed, counts = ops.pair_scores_catalog_compact(
                fa, fb, chunk_t, threshold=threshold, block_m=bm,
                block_n=bn, capacity=capacity, impl=impl)
            counts = counts.reshape(-1).cpu().numpy().astype(np.int64)
            t1 = time.perf_counter()
            stage1_stats["kernel_seconds"] += t1 - t0
            kmax = int(counts.max(initial=0))
            if kmax <= capacity:
                stage1_stats["compact_decodes"] += 1
                ra, rb = _decode_packed(packed[:, :kmax].cpu().numpy(),
                                        counts, chunk, bm, bn)
                stage1_stats["decode_seconds"] += time.perf_counter() - t1
                out_a.append(ra)
                out_b.append(rb)
                continue
            # Exact counts flagged dropped survivors: re-score this
            # chunk through the dense mask (exactness over speed).
            stage1_stats["compact_overflows"] += 1
        t0 = time.perf_counter()
        mask = ops.pair_scores_catalog(fa, fb, chunk_t, threshold=threshold,
                                       block_m=bm, block_n=bn, impl=impl)
        _sync(dev)
        t1 = time.perf_counter()
        stage1_stats["kernel_seconds"] += t1 - t0
        stage1_stats["nonzero_decodes"] += 1
        ti, ii, jj = (x.cpu().numpy()
                      for x in torch.nonzero(mask, as_tuple=True))
        out_a.append(chunk[ti, A_TILE].astype(np.int64) * bm + ii)
        out_b.append(chunk[ti, B_TILE].astype(np.int64) * bn + jj)
        stage1_stats["decode_seconds"] += time.perf_counter() - t1
    if not out_a:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(out_a), np.concatenate(out_b)


def execute(catalog: TileCatalog, feats_a, feats_b=None, *,
            threshold: float, impl: str = "auto", mesh=None,
            chunk_tiles: int = 1024, compact: bool = True,
            compact_capacity: Optional[int] = None,
            device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Stage 1 of any lowered catalog on one device: chunked
    :func:`score_catalog`. Returns host int64 (rows_a, rows_b); run
    stage 2 via :func:`verify_pairs`."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh execution is not ported yet (ROADMAP Queue 1 item 10: "
            "mesh)")
    return score_catalog(feats_a, catalog, feats_b, threshold=threshold,
                         impl=impl, chunk_tiles=chunk_tiles, compact=compact,
                         compact_capacity=compact_capacity, device=device)


_VERIFY_CHUNK = 8_192


def verify_pairs(codes_a, lens_a, codes_b, lens_b, rows_a, rows_b,
                 threshold: float, chunk: int = _VERIFY_CHUNK,
                 device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Stage 2: exact normalized edit similarity >= threshold on candidate
    row pairs, in chunks of ``chunk`` pairs on ``device``. Codes and
    lengths (numpy or tensors) move to the device once; the similarities
    come back as f32 and are compared with the threshold on the host, as
    in the JAX package."""
    from ..similarity import edit_similarity

    dev = resolve_device(device)
    ca, la = _to_device(codes_a, dev), _to_device(lens_a, dev)
    if codes_b is codes_a and lens_b is lens_a:
        cb, lb = ca, la
    else:
        cb, lb = _to_device(codes_b, dev), _to_device(lens_b, dev)
    rows_a = np.asarray(rows_a, np.int64)
    rows_b = np.asarray(rows_b, np.int64)
    hit_a, hit_b = [], []
    for lo in range(0, rows_a.shape[0], chunk):
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
                  impl: str = "auto", mesh=None, chunk_tiles: int = 1024,
                  compact_capacity: Optional[int] = None,
                  device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Fused filter-and-verify: kernel stage 1 over the tile catalog,
    exact stage 2 on its survivors. Returns matched (rows_a, rows_b) —
    indices into the a-side (and b-side, if distinct) arrays."""
    cand_a, cand_b = execute(
        catalog, feats_a, feats_b, threshold=threshold - filter_margin,
        impl=impl, mesh=mesh, chunk_tiles=chunk_tiles,
        compact_capacity=compact_capacity, device=device)
    if codes_b is None:
        codes_b, lens_b = codes_a, lens_a
    return verify_pairs(codes_a, lens_a, codes_b, lens_b, cand_a, cand_b,
                        threshold, device=device)

"""The reference of a batch run over the blocked strategies, streamed.

``check.batch_expected`` keeps the cosine of every pair a run considers,
which at the paper's DS2 (5.95·10⁹ pairs) is ~143 GB of host arrays.
:func:`batch_expected` gives the same dict (survivor keys, band keys,
matches, band pairs, pairs considered) from the same semantics
(``reference.er``): the float64 (or TF32) cosines of one group of blocks
at a time are taken on the device, and only the pairs that survive stage
1 (``cos >= threshold − margin``) or lie in the band (``|cos − (threshold
− margin)| < BAND``) come back to the host. A block larger than a group
is scored in row strips of its upper triangle, and the match_⊥ job
(every entity against each key-less one, self pairs included) in strips
of entities. Stage 2 runs on the survivors with ``reference.er.verify``.
So no more than one group's pairs are held at once; what is kept grows
with the survivors alone.

NumPy and plain PyTorch; nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from ..check import _SEED, _mix, row_hash
from . import er as ref

GROUP_CELLS = 1 << 27        # cosines taken at once, as in ``reference.er``
MAX_ROWS = 1 << 19           # gathered feature rows a group, likewise
VERIFY_CHUNK = 1 << 21       # survivors a stage-2 call


def _kept(g: torch.Tensor, valid: torch.Tensor, thr: float):
    """Indices (k, g.dim()) and cosines of the ``valid`` cells of ``g``
    that survive or lie in the band, on ``g``'s device."""
    keep = valid & ((g >= thr) | ((g - thr).abs() < ref.BAND))
    return torch.nonzero(keep), g[keep]


def _padded(feats, rows, cap, st, sz, precision, thr, cells):
    """Blocks of one padded size ``cap``, batched as ``reference.er``
    batches them: (ia, ib, cos) of their kept upper-triangle pairs."""
    dev = feats.device
    upper = torch.ones(cap, cap, dtype=torch.bool, device=dev).triu(1)
    step = max(1, min(cells // (cap * cap), MAX_ROWS // cap))
    for lo in range(0, st.size, step):
        s, z = st[lo:lo + step], sz[lo:lo + step]
        slot = np.arange(cap)[None, :]
        idx = np.where(slot < z[:, None], s[:, None] + slot, -1)
        g_rows = torch.as_tensor(rows[np.maximum(idx, 0)], device=dev)
        x = feats[g_rows]
        real = torch.as_tensor(idx >= 0, device=dev)
        valid = real[:, :, None] & real[:, None, :] & upper
        k, cos = _kept(ref.gram(x, x, precision), valid, thr)
        yield g_rows[k[:, 0], k[:, 1]], g_rows[k[:, 0], k[:, 2]], cos


def _striped(feats, r, precision, thr, cells):
    """One block whose rows are ``r``, larger than a group: strips of its
    rows against every later row of the block."""
    dev = feats.device
    r = torch.as_tensor(r, device=dev)
    z = r.numel()
    step = max(1, cells // z)
    for lo in range(0, z - 1, step):
        hi = min(lo + step, z - 1)
        valid = (torch.arange(z - lo, device=dev)[None, :]
                 > torch.arange(hi - lo, device=dev)[:, None])
        k, cos = _kept(ref.gram(feats[r[lo:hi]], feats[r[lo:]], precision),
                       valid, thr)
        yield r[lo + k[:, 0]], r[lo + k[:, 1]], cos


def _null_strips(feats, null, precision, thr, cells):
    """The match_⊥ job: every entity ``x`` against each key-less ``u``,
    as ordered pairs (x, u), in strips of entities."""
    dev = feats.device
    n = feats.shape[0]
    null = torch.as_tensor(null, device=dev)
    y = feats[null]
    step = max(1, cells // null.numel())
    for lo in range(0, n, step):
        g = ref.gram(feats[lo:min(lo + step, n)], y, precision)
        k, cos = _kept(g, torch.ones_like(g, dtype=torch.bool), thr)
        yield lo + k[:, 0], null[k[:, 1]], cos


def pair_keys(ha, hb, device) -> np.ndarray:
    """``check.pair_keys(ha, hb, ordered=False)``, computed in torch on
    ``device`` (the same 64-bit arithmetic, which wraps alike)."""
    a = torch.as_tensor(ha, device=device)
    b = torch.as_tensor(hb, device=device)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    return _mix(_mix(lo ^ _SEED) ^ hi).cpu().numpy()


def _blocks(titles: Sequence[str], k: int):
    """Blocking as ``reference.er.batch_pairs`` does it: entity ids in
    block order, the start and size of each block, the key-less ids."""
    keys = [ref.prefix_key(t, k) for t in titles]
    ids: Dict[str, int] = {}
    keyed = [i for i, key in enumerate(keys) if key is not None]
    null = np.asarray([i for i, key in enumerate(keys) if key is None],
                      np.int64)
    block = np.asarray([ids.setdefault(keys[i], len(ids)) for i in keyed],
                       np.int64)
    rows = np.asarray(keyed, np.int64)[np.argsort(block, kind="stable")]
    sizes = np.bincount(block, minlength=len(ids)).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    return rows, starts, sizes, null


def _scored(feats: torch.Tensor, blocks, er: Dict, precision: str,
            cells: int
            ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(ia, ib, cos) of the pairs that survive stage 1 or lie in the band,
    a group at a time, over every pair a blocked batch run considers."""
    thr = float(er["threshold"]) - float(er["filter_margin"])
    rows, starts, sizes, null = blocks
    big = sizes >= 2
    for cap, st, sz in ref._padded_groups(starts[big], sizes[big]):
        if cap * cap <= cells:
            yield from _padded(feats, rows, cap, st, sz, precision, thr,
                               cells)
            continue
        for s, z in zip(st.tolist(), sz.tolist()):
            yield from _striped(feats, rows[s:s + z], precision, thr, cells)
    if null.size and er.get("match_missing_keys", True):
        yield from _null_strips(feats, null, precision, thr, cells)


def _considered(blocks, n: int, er: Dict) -> int:
    """Pairs a blocked batch run considers."""
    _, _, sizes, null = blocks
    n_null = null.size if er.get("match_missing_keys", True) else 0
    return int((sizes * (sizes - 1) // 2).sum()) + n * n_null


def _pairs(parts) -> Tuple[np.ndarray, np.ndarray]:
    if not parts:
        z = np.zeros(0, np.int64)
        return z, z
    return (np.concatenate([a for a, _ in parts]),
            np.concatenate([b for _, b in parts]))


def batch_expected(titles: Sequence[str], er: Dict, strategy: str, device,
                   precision: str = "float64", cells: int = GROUP_CELLS
                   ) -> Dict:
    """``check.batch_expected`` of a blocked strategy, streamed: the same
    survivor keys (as a multiset), band keys, matches, band pairs and
    count of pairs considered. ``cells`` bounds the cosines a group
    takes; ``precision="tf32"`` is the control."""
    if strategy not in ("pair_range", "block_split", "basic"):
        raise ValueError(f"the streamed reference covers the blocked "
                         f"strategies, not {strategy!r}")
    codes, lens = ref.encode(titles, int(er["max_len"]))
    feats = ref.features(codes, lens, int(er["feature_dim"]), device)
    thr = float(er["threshold"]) - float(er["filter_margin"])
    blocks = _blocks(titles, int(er["prefix_len"]))
    surv, band = [], []
    for ia, ib, cos in _scored(feats, blocks, er, precision, cells):
        s = cos >= thr
        b = (cos - thr).abs() < ref.BAND
        surv.append((ia[s].cpu().numpy(), ib[s].cpu().numpy()))
        band.append((ia[b].cpu().numpy(), ib[b].cpu().numpy()))
    del feats
    sa, sb = _pairs(surv)
    ba, bb = _pairs(band)
    del surv, band
    h = row_hash(codes)
    on_dev = torch.as_tensor(codes, device=device)  # rows gathered there
    hit = ref.verify(on_dev, lens, on_dev, lens, sa, sb,
                     float(er["threshold"]), device, chunk=VERIFY_CHUNK)
    hit &= sa != sb
    lo, hi = np.minimum(sa[hit], sb[hit]), np.maximum(sa[hit], sb[hit])
    return {"survivors": pair_keys(h[sa], h[sb], device),
            "band_keys": pair_keys(h[ba], h[bb], device),
            "matches": set(zip(lo.tolist(), hi.tolist())),
            "band_pairs": set(zip(np.minimum(ba, bb).tolist(),
                                  np.maximum(ba, bb).tolist())),
            "considered": _considered(blocks, len(titles), er)}

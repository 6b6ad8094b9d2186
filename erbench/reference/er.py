"""Plain reference of the entity-resolution semantics that the benchmark
holds the program to. NumPy and plain PyTorch only; nothing here imports
the program or reads what it made.

Semantics (Kolb, Thor and Rahm, arXiv:1108.1631, with the two-stage
matcher of the configuration files):

* features: hashed character 3-gram counts (FNV-1a, 64 bits, modulo the
  feature width) of the title's first ``max_len`` UTF-8 bytes,
  L2-normalised; a title shorter than 3 bytes hashes whole (its zero
  padding included). Computed here in float64.
* blocking: the key is the first ``prefix_len`` characters of the
  stripped, lower-cased title; an empty one is no key. Batch PairRange
  considers every unordered pair of one key once, and, for each entity
  ``u`` without a key, the ordered pairs ``(x, u)`` for every entity
  ``x`` (the match_⊥ job, self pairs included). Sorted Neighborhood
  considers the pairs ``(p, p + k)``, ``0 < k < window``, over the stable
  sort of the normalised titles. The service considers, for a query
  with a key, the corpus entities of that key and those without a key;
  for a query without a key, every corpus entity.
* stage 1 keeps a considered pair whose cosine is ``>= threshold −
  margin``; stage 2 keeps a survivor whose edit similarity ``1 − d /
  max(len_a, len_b, 1)``, computed in float32, is ``>= float32(threshold)``.

``precision="tf32"`` computes the stage-1 products of float32 features
in TF32, the control that the comparison has to fail.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

_FNV_OFFSET = np.uint64(14695981039346656037).astype(np.int64).item()
_FNV_PRIME = 1099511628211
# A pair whose reference cosine lies nearer the stage-1 threshold than
# this is left out of the comparison: float32 dots of two unit vectors
# with at most 62 non-zero products differ from the exact one by at most
# 62 · 2^-24 ≈ 3.7e-6, whatever the order of the sum.
BAND = 4e-6


def prefix_key(title: str, k: int) -> Optional[str]:
    key = title.strip().lower()[:k]
    return key or None


def sn_order(titles: Sequence[str]) -> np.ndarray:
    keys = [t.strip().lower() for t in titles]
    return np.asarray(sorted(range(len(keys)), key=keys.__getitem__),
                      np.int64)


def encode(titles: Sequence[str], max_len: int):
    """(n, max_len) uint8 codes, zero-padded, and (n,) int64 lengths."""
    raw = [t.encode("utf-8", errors="replace")[:max_len] for t in titles]
    lens = np.fromiter((len(r) for r in raw), np.int64, len(raw))
    codes = np.zeros((len(raw), max_len), np.uint8)
    if raw:
        packed = np.array(raw, dtype=f"S{max_len}")
        codes[:] = np.frombuffer(packed.tobytes(), np.uint8).reshape(
            len(raw), max_len)
    return codes, lens


def _fnv(cols: List[torch.Tensor]) -> torch.Tensor:
    h = torch.full_like(cols[0], _FNV_OFFSET)
    for c in cols:
        h = torch.bitwise_xor(h, c) * _FNV_PRIME
    return h


def features(codes: np.ndarray, lens: np.ndarray, dim: int, device,
             n: int = 3, block: int = 1 << 18) -> torch.Tensor:
    """(num, dim) float64 unit rows on ``device``, in blocks of rows."""
    if dim & (dim - 1):
        raise ValueError("the reference hashes into a power-of-two width")
    num, width = codes.shape
    out = torch.zeros((num, dim), dtype=torch.float64, device=device)
    for lo in range(0, num, block):
        c = torch.as_tensor(codes[lo:lo + block], device=device).long()
        ln = torch.as_tensor(lens[lo:lo + block], device=device)
        f = out[lo:lo + c.shape[0]]
        if width >= n:
            win = width - n + 1
            h = _fnv([c[:, k:k + win] for k in range(n)])
            valid = (torch.arange(win, device=device)[None, :] + n
                     <= ln[:, None])
            f.scatter_add_(1, h & (dim - 1), valid.to(torch.float64))
        short = torch.nonzero(ln < n).flatten()
        if short.numel():
            h = _fnv([c[short, k] for k in range(width)])
            f[short, h & (dim - 1)] += 1.0
        f /= torch.linalg.vector_norm(f, dim=1, keepdim=True).clamp_min(1e-12)
    return out


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits), ties to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def gram(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """Batched ``a @ b^T`` in float64, or float32 features in TF32."""
    if precision == "float64":
        return torch.matmul(a, b.transpose(-1, -2))
    if precision != "tf32":
        raise ValueError(f"unknown precision {precision!r}")
    a32, b32 = a.float(), b.float()
    if a.device.type == "cuda":
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return torch.matmul(a32, b32.transpose(-1, -2)).double()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    return torch.matmul(_round_tf32(a32),
                        _round_tf32(b32).transpose(-1, -2)).double()


def _cross_grams(cf: torch.Tensor, qf: torch.Tensor, slot: np.ndarray,
                 pieces, precision: str, max_cells: int = 1 << 26,
                 max_rows: int = 1 << 19):
    """Cosines of every (row, query) of each piece (corpus rows, queries),
    the pieces padded by powers of two into batched products of at most
    ``max_cells`` products and ``max_rows`` gathered rows a side."""
    def cap(x):
        return 1 << int(np.ceil(np.log2(max(x, 1))))
    shapes: Dict[tuple, list] = {}
    for rows, js in pieces:
        step = min(max_cells // cap(js.size), max_rows)
        for lo in range(0, rows.size, step):
            r = rows[lo:lo + step]
            shapes.setdefault((cap(r.size), cap(js.size)), []).append((r, js))
    ia, ib, cs = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)], [
        np.zeros(0)]
    dev = cf.device
    for (rc, qc), group in shapes.items():
        step = max(1, min(max_cells // (rc * qc), max_rows // rc))
        for lo in range(0, len(group), step):
            part = group[lo:lo + step]
            ri = np.full((len(part), rc), -1, np.int64)
            qi = np.full((len(part), qc), -1, np.int64)
            for g, (r, js) in enumerate(part):
                ri[g, :r.size] = r
                qi[g, :js.size] = js
            x = cf[torch.as_tensor(slot[np.maximum(ri, 0)], device=dev)]
            y = qf[torch.as_tensor(np.maximum(qi, 0), device=dev)]
            gm = gram(x, y, precision).cpu().numpy()
            g, p, q = np.nonzero((ri[:, :, None] >= 0) & (qi[:, None, :] >= 0))
            ia.append(ri[g, p])
            ib.append(qi[g, q])
            cs.append(gm[g, p, q])
    return np.concatenate(ia), np.concatenate(ib), np.concatenate(cs)


def edit_distance(a: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
                  lb: torch.Tensor) -> torch.Tensor:
    """Levenshtein distance of each row pair: the textbook recurrence

        D[i][j] = min(D[i-1][j] + 1, D[i][j-1] + 1,
                      D[i-1][j-1] + (a[i-1] != b[j-1]))

    swept one anti-diagonal ``i + j = k`` at a time (a row indexed by
    ``i``), over all pairs at once; ``D[la][lb]`` is read on diagonal
    ``la + lb``."""
    p = a.shape[0]
    dev = a.device
    w = int(torch.maximum(la.max(), lb.max())) if p else 0
    t = torch.int16                       # distances are at most 2 * 64
    inf = 1 << 14
    a = a[:, :w].to(t)
    # b reversed and padded, so that b[j - 1] for i = 1..w on diagonal k
    # is the contiguous slice [2w + 2 - k, 3w + 2 - k)
    pad = torch.full((p, w + 1), -1, dtype=t, device=dev)
    bp = torch.cat([pad, b[:, :w].to(t).flip(1), pad], dim=1)
    i = torch.arange(w + 1, device=dev)
    big = torch.tensor(inf, dtype=t, device=dev)
    out = torch.zeros(p, dtype=torch.long, device=dev)
    end = (la + lb).long()
    prev2 = torch.full((p, w + 1), inf, dtype=t, device=dev)
    prev = prev2.clone()
    for k in range(2 * w + 1):
        cost = (a != bp[:, 2 * w + 2 - k:3 * w + 2 - k]).to(t)
        inner = torch.minimum(torch.minimum(prev[:, :-1], prev[:, 1:]) + 1,
                              prev2[:, :-1] + cost)
        first = torch.full((p, 1), k if k <= w else inf, dtype=t,
                           device=dev)
        cur = torch.cat([first, inner], dim=1)
        cur = torch.where(((i > k) | (i < k - w))[None, :], big, cur)
        hit = end == k
        if hit.any():
            out[hit] = cur[hit].gather(1, la[hit].long()[:, None])[:, 0].long()
        prev2, prev = prev, cur
    return out


def similarity_keeps(d: np.ndarray, la: np.ndarray, lb: np.ndarray,
                     threshold: float) -> np.ndarray:
    mx = np.maximum(np.maximum(la, lb), 1).astype(np.float32)
    sim = np.float32(1.0) - d.astype(np.float32) / mx
    return sim >= np.float32(threshold)


def verify(codes_a, lens_a, codes_b, lens_b, ia, ib, threshold, device,
           chunk: int = 1 << 17) -> np.ndarray:
    """Stage 2 on the pairs (ia, ib): a bool per pair."""
    keep = np.zeros(ia.size, bool)
    for lo in range(0, ia.size, chunk):
        a, b = ia[lo:lo + chunk], ib[lo:lo + chunk]
        la, lb = lens_a[a], lens_b[b]
        d = edit_distance(
            torch.as_tensor(codes_a[a], device=device),
            torch.as_tensor(la, device=device),
            torch.as_tensor(codes_b[b], device=device),
            torch.as_tensor(lb, device=device)).cpu().numpy()
        keep[lo:lo + chunk] = similarity_keeps(d, la, lb, threshold)
    return keep


@dataclass
class Pairs:
    """Scored pairs: indices into the a- and b-side, the cosine, and the
    two stages' verdicts."""
    ia: np.ndarray
    ib: np.ndarray
    cos: np.ndarray
    survives: np.ndarray
    matches: np.ndarray
    stage1_threshold: float

    @property
    def in_band(self) -> np.ndarray:
        return np.abs(self.cos - self.stage1_threshold) < BAND


def _finish(ia, ib, cos, thr, codes_a, lens_a, codes_b, lens_b, threshold,
            device) -> Pairs:
    survives = cos >= thr
    matches = np.zeros(ia.size, bool)
    s = np.flatnonzero(survives)
    matches[s] = verify(codes_a, lens_a, codes_b, lens_b, ia[s], ib[s],
                        threshold, device)
    return Pairs(ia=ia, ib=ib, cos=cos, survives=survives, matches=matches,
                 stage1_threshold=thr)


def _padded_groups(starts: np.ndarray, sizes: np.ndarray):
    """Blocks grouped by the power of two their size rounds up to."""
    cap = np.maximum(2, 1 << np.ceil(np.log2(np.maximum(sizes, 1))).astype(
        np.int64))
    for c in np.unique(cap):
        sel = np.flatnonzero(cap == c)
        yield int(c), starts[sel], sizes[sel]


def _block_pairs(feats: torch.Tensor, rows: np.ndarray, starts: np.ndarray,
                 sizes: np.ndarray, precision: str, max_cells: int = 1 << 27,
                 max_rows: int = 1 << 19):
    """Upper-triangle cosines of every block of ``rows`` (blocks
    contiguous in ``rows``): (ia, ib, cos) with ia < ib in block order."""
    dev = feats.device
    ia, ib, cs = [], [], []
    for cap, st, sz in _padded_groups(starts, sizes):
        step = max(1, min(max_cells // (cap * cap), max_rows // cap))
        for lo in range(0, st.size, step):
            s, z = st[lo:lo + step], sz[lo:lo + step]
            slot = np.arange(cap)[None, :]
            idx = np.where(slot < z[:, None], s[:, None] + slot, -1)
            g_rows = rows[np.maximum(idx, 0)]
            x = feats[torch.as_tensor(g_rows, device=dev)]
            g = gram(x, x, precision).cpu().numpy()
            bi, pi, qi = np.nonzero(np.triu(
                (idx[:, :, None] >= 0) & (idx[:, None, :] >= 0), 1))
            ia.append(g_rows[bi, pi])
            ib.append(g_rows[bi, qi])
            cs.append(g[bi, pi, qi])
    if not ia:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0)
    return np.concatenate(ia), np.concatenate(ib), np.concatenate(cs)


def batch_pairs(titles: Sequence[str], er: Dict, strategy: str, device,
                precision: str = "float64") -> Pairs:
    """Every pair that a one-shot batch run considers, scored."""
    codes, lens = encode(titles, int(er["max_len"]))
    feats = features(codes, lens, int(er["feature_dim"]), device)
    thr = float(er["threshold"]) - float(er["filter_margin"])
    n = len(titles)
    if strategy == "sorted_neighborhood":
        order = sn_order(titles)
        w = min(int(er["window"]), n)
        tile = 128
        starts = np.arange(0, n, tile)
        sizes = np.minimum(tile + w - 1, n - starts)
        ia, ib, cs = [], [], []
        for cap, st, sz in _padded_groups(starts, sizes):
            slot = np.arange(cap)[None, :]
            idx = np.where(slot < sz[:, None], st[:, None] + slot, -1)
            x = feats[torch.as_tensor(order[np.maximum(idx, 0)],
                                      device=device)]
            g = gram(x, x, precision).cpu().numpy()
            off = slot - slot.T                        # q − p
            ok = ((idx[:, :, None] >= 0) & (idx[:, None, :] >= 0)
                  & (off[None] > 0) & (off[None] < w)
                  & (slot[0][None, :, None] < tile))
            bi, pi, qi = np.nonzero(ok)
            ia.append(order[idx[bi, pi]])
            ib.append(order[idx[bi, qi]])
            cs.append(g[bi, pi, qi])
        ia, ib, cs = (np.concatenate(v) for v in (ia, ib, cs))
    elif strategy in ("pair_range", "block_split", "basic"):
        k = int(er["prefix_len"])
        keys = [prefix_key(t, k) for t in titles]
        keyed = [i for i, key in enumerate(keys) if key is not None]
        null = np.asarray([i for i, key in enumerate(keys) if key is None],
                          np.int64)
        ids: Dict[str, int] = {}
        block = np.asarray([ids.setdefault(keys[i], len(ids)) for i in keyed],
                           np.int64)
        order = np.argsort(block, kind="stable")
        rows = np.asarray(keyed, np.int64)[order]
        sizes = np.bincount(block, minlength=len(ids)).astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        big = sizes >= 2
        ia, ib, cs = _block_pairs(feats, rows, starts[big], sizes[big],
                                  precision)
        if null.size and er.get("match_missing_keys", True):
            g = gram(feats, feats[torch.as_tensor(null, device=device)],
                     precision).cpu().numpy()
            ia = np.concatenate([ia, np.repeat(np.arange(n), null.size)])
            ib = np.concatenate([ib, np.tile(null, n)])
            cs = np.concatenate([cs, g.ravel()])
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return _finish(ia, ib, cs, thr, codes, lens, codes, lens,
                   float(er["threshold"]), device)


def service_pairs(corpus: Sequence[str], queries: Sequence[str], svc: Dict,
                  device, precision: str = "float64",
                  corpus_codes=None) -> Pairs:
    """Every (corpus entity, query) pair that the service considers for
    the distinct ``queries``, scored; ``ib`` indexes ``queries``."""
    max_len, dim = int(svc["max_len"]), int(svc["feature_dim"])
    k = int(svc["prefix_len"])
    c_codes, c_lens = (corpus_codes if corpus_codes is not None
                       else encode(corpus, max_len))
    q_codes, q_lens = encode(queries, max_len)
    c_keys = [prefix_key(t, k) for t in corpus]
    by_key: Dict[Optional[str], List[int]] = {}
    for i, key in enumerate(c_keys):
        by_key.setdefault(key, []).append(i)
    null_rows = np.asarray(by_key.get(None, []), np.int64)
    groups: Dict[Optional[str], List[int]] = {}
    for j, q in enumerate(queries):
        groups.setdefault(prefix_key(q, k), []).append(j)
    need = set()
    for key in groups:
        need.update(range(len(corpus)) if key is None else by_key.get(key, []))
    need.update(null_rows.tolist())
    need = np.asarray(sorted(need), np.int64)
    slot = np.full(len(corpus), -1, np.int64)
    slot[need] = np.arange(need.size)
    cf = features(c_codes[need], c_lens[need], dim, device)
    qf = features(q_codes, q_lens, dim, device)
    pieces = []
    for key, js in groups.items():
        rows = (np.arange(len(corpus)) if key is None else np.concatenate(
            [np.asarray(by_key.get(key, []), np.int64), null_rows]))
        if rows.size:
            pieces.append((rows, np.asarray(js, np.int64)))
    ia, ib, cs = _cross_grams(cf, qf, slot, pieces, precision)
    thr = float(svc["threshold"]) - float(svc["filter_margin"])
    return _finish(ia, ib, cs, thr, c_codes, c_lens, q_codes, q_lens,
                   float(svc["threshold"]), device)

"""The comparison that decides ``correct``.

The program's stage-1 survivors are read where stage 2 receives them:
``record_survivors`` wraps ``verify_pairs`` in the program's pipeline and
service modules, and keeps each call's code rows and survivor indices.
A pair is known by the content of its two code rows (a 64-bit hash of
each row), so the program's blocked or batched coordinates need no
translation, and a pair the program scores twice counts twice.

Numbers compared, each against the cell's limit in ``limits/<cell>.json``:

* ``survivor_diff``: pairs by which the program's multiset of stage-1
  survivors differs from the reference's, leaving out pairs whose
  reference cosine lies within ``reference.er.BAND`` of the threshold;
* ``match_diff``: pairs by which the program's final match set differs
  from the reference's, with the same pairs left out;
* ``failed``: runs or requests that raised or never answered.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from .reference import er as ref

_SEED = np.uint64(0x9E3779B97F4A7C15).astype(np.int64).item()
_M1 = np.uint64(0xBF58476D1CE4E5B9).astype(np.int64).item()
_M2 = np.uint64(0x94D049BB133111EB).astype(np.int64).item()


def _shr(x, s: int):
    """Logical right shift of int64 values (torch or numpy)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix(z):
    """SplitMix64's finaliser: a bijection of 64-bit values that spreads
    every input bit over the output."""
    z = (z ^ _shr(z, 30)) * _M1
    z = (z ^ _shr(z, 27)) * _M2
    return z ^ _shr(z, 31)


def row_hash(codes) -> np.ndarray:
    """A 64-bit hash of each (m, L) uint8 code row: the row's 8-byte words
    folded one after another through :func:`_mix`, on the rows' device."""
    t = torch.as_tensor(codes)
    m, width = t.shape
    if m == 0:
        return np.zeros(0, np.int64)
    pad = (-width) % 8
    if pad:
        t = torch.nn.functional.pad(t, (0, pad))
    w = t.contiguous().view(torch.int64)
    h = torch.full((m,), _SEED, dtype=torch.int64, device=w.device)
    for k in range(w.shape[1]):
        h = _mix(h ^ w[:, k])
    return h.cpu().numpy()


def pair_keys(ha: np.ndarray, hb: np.ndarray, ordered: bool) -> np.ndarray:
    """One int64 key per pair; unordered pairs are sorted first."""
    a, b = (ha, hb) if ordered else (np.minimum(ha, hb), np.maximum(ha, hb))
    return _mix(_mix(a ^ _SEED) ^ b)


class SurvivorLog:
    """Stage-1 survivors handed to stage 2 while the log is open: per call
    the a- and b-side code rows and the survivor indices, kept as the
    program passed them (no copy inside the window)."""

    def __init__(self):
        self.calls: List[Tuple] = []
        self.open = False

    def take(self) -> List[Tuple]:
        out, self.calls = self.calls, []
        return out


@contextlib.contextmanager
def record_survivors(log: SurvivorLog, modules: Iterable):
    """Wrap ``verify_pairs`` in each of ``modules`` so that its survivors
    go to ``log`` while ``log.open``; restore it on exit."""
    saved = []
    for mod in modules:
        inner = mod.verify_pairs

        def wrapper(codes_a, lens_a, codes_b, lens_b, rows_a, rows_b,
                    *args, _inner=inner, **kwargs):
            if log.open:
                log.calls.append((codes_a, codes_b, rows_a, rows_b))
            return _inner(codes_a, lens_a, codes_b, lens_b, rows_a, rows_b,
                          *args, **kwargs)

        saved.append((mod, inner))
        mod.verify_pairs = wrapper
    try:
        yield log
    finally:
        for mod, inner in saved:
            mod.verify_pairs = inner


def survivor_hashes(calls: Sequence[Tuple]) -> Tuple[np.ndarray, np.ndarray]:
    """(a-side row hash, b-side row hash) of every logged survivor."""
    ha, hb = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for codes_a, codes_b, rows_a, rows_b in calls:
        ra = np.asarray(rows_a, np.int64)
        rb = np.asarray(rows_b, np.int64)
        if not ra.size:
            continue
        for codes, rows, out in ((codes_a, ra, ha), (codes_b, rb, hb)):
            t = torch.as_tensor(codes)
            out.append(row_hash(t[torch.as_tensor(rows, device=t.device)]))
    return np.concatenate(ha), np.concatenate(hb)


def multiset_diff(got: np.ndarray, want: np.ndarray,
                  skip: np.ndarray) -> int:
    """Σ |count in got − count in want| over keys not in ``skip``."""
    keys, inv = np.unique(np.concatenate([got, want]), return_inverse=True)
    diff = np.abs(np.bincount(inv[:got.size], minlength=keys.size)
                  - np.bincount(inv[got.size:], minlength=keys.size))
    return int(diff[~np.isin(keys, skip)].sum())


def set_diff(got: set, want: set, skip: set) -> int:
    return len((got ^ want) - skip)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or a limit without a number, fails."""
    out = {name: {"value": numbers.get(name), "limit": limits[name]}
           for name in limits}
    ok = all(v["value"] is not None and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out


# ---- the reference's side ------------------------------------------------

def batch_expected(titles: Sequence[str], er: Dict, strategy: str, device,
                   precision: str = "float64") -> Dict:
    """What a batch run must produce: survivor keys, match index pairs,
    and the in-band pairs left out of both comparisons."""
    p = ref.batch_pairs(titles, er, strategy, device, precision)
    codes, _ = ref.encode(titles, int(er["max_len"]))
    h = row_hash(codes)
    band = p.in_band
    keys = pair_keys(h[p.ia], h[p.ib], ordered=False)
    lo, hi = np.minimum(p.ia, p.ib), np.maximum(p.ia, p.ib)
    hit = p.matches & (p.ia != p.ib)
    return {"survivors": keys[p.survives], "band_keys": keys[band],
            "matches": set(zip(lo[hit].tolist(), hi[hit].tolist())),
            "band_pairs": set(zip(lo[band].tolist(), hi[band].tolist())),
            "considered": int(p.ia.size)}


def batch_numbers(runs: List[Dict], want: Dict) -> Dict[str, float]:
    """The numbers of a batch window: the worst run for each."""
    surv, match = 0, 0
    for run in runs:
        if run.get("error"):
            continue
        ha, hb = run["survivor_hashes"]
        got = pair_keys(ha, hb, ordered=False)
        surv = max(surv, multiset_diff(got, want["survivors"],
                                       want["band_keys"]))
        match = max(match, set_diff(run["matches"], want["matches"],
                                    want["band_pairs"]))
    return {"survivor_diff": surv, "match_diff": match,
            "failed": sum(1 for r in runs if r.get("error"))}


def service_expected(corpus: Sequence[str], queries: Sequence[str],
                     svc: Dict, device, precision: str = "float64") -> Dict:
    """Per distinct query title: the corpus entities that survive stage 1,
    match, or lie in the band; with the content hashes of both sides."""
    c_codes = ref.encode(corpus, int(svc["max_len"]))
    p = ref.service_pairs(corpus, queries, svc, device, precision,
                          corpus_codes=c_codes)
    hc = row_hash(c_codes[0])
    hq = row_hash(ref.encode(queries, int(svc["max_len"]))[0])
    return {"pairs": p, "corpus_hash": hc, "query_hash": hq,
            "queries": list(queries)}


def service_numbers(want: Dict, sample: List[Tuple[List[str], set]],
                    occurrences: Dict[str, int],
                    survivor_hashes_: Tuple[np.ndarray, np.ndarray],
                    failed: int) -> Dict[str, float]:
    """``sample``: (request titles, served (corpus, query) pairs) of each
    request compared; ``occurrences``: how often each sampled title was
    sent in the whole window (every copy reaches stage 1)."""
    p = want["pairs"]
    hc, hq = want["corpus_hash"], want["query_hash"]
    titles = want["queries"]
    band = p.in_band
    reps = np.asarray([occurrences[titles[j]] for j in p.ib], np.int64)
    keys = pair_keys(hc[p.ia], hq[p.ib], ordered=True)
    want_keys = np.repeat(keys[p.survives], reps[p.survives])
    ha, hb = survivor_hashes_
    mine = np.isin(hb, hq)
    got = pair_keys(ha[mine], hb[mine], ordered=True)
    surv = multiset_diff(got, want_keys, keys[band])
    pos = {t: j for j, t in enumerate(titles)}
    matches: Dict[int, set] = {}
    banded: Dict[int, set] = {}
    for sel, out in ((p.matches, matches), (band, banded)):
        for a, b in zip(p.ia[sel].tolist(), p.ib[sel].tolist()):
            out.setdefault(b, set()).add(a)
    match = 0
    for req, served in sample:
        exp, skip = set(), set()
        for j, t in enumerate(req):
            exp.update((c, j) for c in matches.get(pos[t], ()))
            skip.update((c, j) for c in banded.get(pos[t], ()))
        match += set_diff(set(served), exp, skip)
    return {"survivor_diff": surv, "match_diff": match, "failed": failed}

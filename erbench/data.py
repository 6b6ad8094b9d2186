"""Inputs of the benchmark, made from ``--seed``: the corpus titles and the
service's request stream.

The corpus follows the block-size law of the paper's Fig. 8 stand-ins
(``make_products`` / ``make_publications`` of the program): a head block
of ``head_frac`` of the entities holding ``pair_share`` of the pairs, a
power-law tail calibrated by bisection, one fixed-width prefix per block
(the blocking key), titles ``"<prefix> <word> <word> <serial>"``, and
``dup_frac`` near-duplicates made by one or two edits past the prefix.
The block sizes depend on ``n`` alone, so every seed carries the same
blocks; the seed picks the words, serials, duplicates and the input
order. Everything is drawn in bulk with numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

WORDS = (
    "laptop", "phone", "camera", "monitor", "keyboard", "mouse", "printer",
    "router", "speaker", "headset", "tablet", "charger", "adapter", "cable",
    "drive", "memory", "battery", "case", "stand", "dock", "hub", "lens",
    "pro", "max", "ultra", "mini", "air", "plus", "lite", "neo", "prime",
)
ALPHABET = "abcdefghijklmnopqrstuvwxyz0123456789"
NULL_KEY_QUERY = ""                       # no blocking key: match_⊥
NEW_BLOCK_QUERY = "@@@@ brand new block"  # a key no corpus title has


def block_sizes(n: int, head_frac: float, pair_share: float) -> np.ndarray:
    """Head block of ``round(head_frac·n)`` entities, then sizes ∝ k^−a
    (floor 1, capped at the head), with ``a`` bisected so that the head
    block holds ``pair_share`` of all pairs."""
    head = max(2, int(round(head_frac * n)))
    rest = n - head
    head_pairs = head * (head - 1) // 2

    def tail(a: float) -> np.ndarray:
        b_guess = max(8, rest // 3)
        w = np.power(np.arange(1, b_guess + 1, dtype=np.float64), -a)
        s = np.maximum(1, np.round(w * (rest / w.sum()))).astype(np.int64)
        s = np.minimum(s, head)
        c = np.cumsum(s)
        cut = int(np.searchsorted(c, rest, side="left")) + 1
        s = s[:cut]
        s[-1] -= int(c[min(cut - 1, len(c) - 1)] - rest)
        if s[-1] <= 0:
            s = s[:-1]
        return s[s > 0]

    lo, hi = 0.01, 3.0
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        s = tail(mid)
        share = head_pairs / (head_pairs + float((s * (s - 1) // 2).sum()))
        if share > pair_share:
            lo = mid
        else:
            hi = mid
    return np.concatenate([[head], tail(0.5 * (lo + hi))]).astype(np.int64)


def prefixes(count: int) -> tuple:
    """``count`` distinct fixed-width prefixes over ``ALPHABET`` in
    lexicographic order, and their width (at least 3)."""
    width = 3
    while len(ALPHABET) ** width < count:
        width += 1
    idx = np.arange(count, dtype=np.int64)
    digits = np.empty((count, width), np.int64)
    for p in range(width - 1, -1, -1):
        digits[:, p] = idx % len(ALPHABET)
        idx //= len(ALPHABET)
    table = np.frombuffer(ALPHABET.encode(), np.uint8)
    raw = table[digits].astype(np.uint8)
    return [bytes(r).decode() for r in raw], width


def _perturb(rng: np.random.Generator, title: str, keep: int) -> str:
    """One or two edits (delete, insert, substitute) past position
    ``keep``, so the block is kept."""
    s = list(title)
    for _ in range(int(rng.integers(1, 3))):
        op = int(rng.integers(0, 3))
        pos = keep + int(rng.integers(0, max(1, len(s) - keep)))
        ch = ALPHABET[int(rng.integers(0, 26))]
        if op == 0 and len(s) > 12:
            del s[min(pos, len(s) - 1)]
        elif op == 1:
            s.insert(min(pos, len(s)), ch)
        else:
            s[min(pos, len(s) - 1)] = ch
    return "".join(s)


@dataclass
class Corpus:
    titles: List[str]
    key_width: int           # prefix width that recovers the blocks


def make_corpus(law: Dict, seed: int) -> Corpus:
    """The corpus of a configuration's ``data`` law for ``seed``."""
    n = int(law["n"])
    dup_frac = float(law["dup_frac"])
    rng = np.random.default_rng(int(seed))
    base = int(n / (1 + dup_frac))
    sizes = block_sizes(base, float(law["head_frac"]), float(law["pair_share"]))
    pre, width = prefixes(len(sizes))
    owner = np.repeat(np.arange(len(sizes)), sizes)
    words = rng.integers(0, len(WORDS), (owner.size, 2))
    serial = rng.integers(0, 10_000, owner.size)
    titles = [f"{pre[b]} {WORDS[a]} {WORDS[c]} {v:04d}"
              for b, a, c, v in zip(owner.tolist(), words[:, 0].tolist(),
                                    words[:, 1].tolist(), serial.tolist())]
    n_dup = int(len(titles) * dup_frac)
    src = rng.choice(len(titles), size=n_dup, replace=False)
    titles.extend(_perturb(rng, titles[int(i)], width) for i in src)
    perm = rng.permutation(len(titles))
    return Corpus(titles=[titles[i] for i in perm.tolist()], key_width=width)


class RequestStream:
    """One closed-loop client's requests, drawn from the seed in bulk.

    Request sizes run through shuffled copies of ``size_min..size_max``,
    so every seed sends the same multiset of sizes, in another order.
    Each query is a corpus title with one character, at a position past
    the block key, replaced by a letter; the request numbered
    ``null_at`` modulo ``every`` leads with a title that has no key, the
    one numbered ``new_at`` with a key that no corpus title has.
    """

    def __init__(self, corpus: Sequence[str], key_width: int, traffic: Dict,
                 seed: int, client: int, n_requests: int):
        lo, hi = int(traffic["size_min"]), int(traffic["size_max"])
        rng = np.random.default_rng([int(seed), 7919, int(client)])
        span = hi - lo + 1
        reps = -(-n_requests // span)
        self.sizes = np.concatenate(
            [rng.permutation(span) + lo for _ in range(reps)])[:n_requests]
        total = int(self.sizes.sum())
        self.pick = rng.integers(0, len(corpus), total)
        self.where = rng.random(total)
        self.char = rng.integers(0, 26, total)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self.corpus = corpus
        self.key_width = key_width
        self.every = int(traffic["special_every"])
        self.null_at = int(traffic["null_key_at"])
        self.new_at = int(traffic["new_block_at"])

    def __len__(self) -> int:
        return int(self.sizes.size)

    def request(self, k: int) -> List[str]:
        lo, hi = int(self.offsets[k]), int(self.offsets[k + 1])
        out = []
        kw = self.key_width
        for q in range(lo, hi):
            t = self.corpus[int(self.pick[q])]
            room = len(t) - kw
            if room <= 0:
                out.append(t)
                continue
            p = kw + int(self.where[q] * room)
            out.append(t[:p] + ALPHABET[int(self.char[q])] + t[p + 1:])
        phase = k % self.every
        if phase == self.null_at:
            out[0] = NULL_KEY_QUERY
        elif phase == self.new_at:
            out[0] = NEW_BLOCK_QUERY
        return out

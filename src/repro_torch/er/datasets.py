"""Synthetic stand-ins for the paper's evaluation datasets (Fig. 8).

DS1 (~114,000 product descriptions) and DS2 (~1.39M publication records)
are not shipped offline, so we generate corpora whose *blocking
statistics* match Fig. 8's regime under prefix blocking:

  DS1: largest block ≈ 71% of all pairs (a single dominating block);
  DS2: largest block ≈ 4% of entities / 26% of pairs, ~10× more blocks.

(The printed DS1 row — 1,483 blocks, 1.1·10⁵ entities, 3·10⁶ pairs — is
internally inconsistent: Cauchy-Schwarz forces ≥ 4.3·10⁶ pairs for those
block counts. We therefore match the *skew shares*, which drive the
paper's findings, and let block counts float; see EXPERIMENTS.md.)

Construction: block sizes are generated directly (head block = target
entity share; power-law mid tier; geometric tail), the tail exponent is
calibrated by bisection so the head block's share of pairs hits the
target. Each block gets a unique 3-char prefix over [a-z0-9] (36³ key
space), so ``prefix_block_ids(titles, 3)`` recovers exactly this layout —
the generator *is* the paper's "first three letters of the title"
blocking. Ground-truth duplicates are injected by perturbing titles past
position 3 (preserving the block) at edit-similarity ≳ 0.8, so matcher
accuracy is testable alongside throughput.

Deterministic in ``seed``; ``n`` rescales everything for tests.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Set, Tuple

import numpy as np

__all__ = ["Dataset", "make_products", "make_publications", "skewed_block_sizes"]

_WORDS = [
    "laptop", "phone", "camera", "monitor", "keyboard", "mouse", "printer",
    "router", "speaker", "headset", "tablet", "charger", "adapter", "cable",
    "drive", "memory", "battery", "case", "stand", "dock", "hub", "lens",
    "pro", "max", "ultra", "mini", "air", "plus", "lite", "neo", "prime",
]


@dataclass
class Dataset:
    """titles + ground-truth duplicate pairs (indices into titles)."""
    name: str
    titles: List[str]
    true_pairs: Set[Tuple[int, int]] = field(default_factory=set)
    prefix_len: int = 3   # blocking-key length that recovers the layout

    @property
    def n(self) -> int:
        return len(self.titles)


def skewed_block_sizes(n: int, head_frac: float, pair_share: float,
                       rng: np.random.Generator) -> np.ndarray:
    """Block sizes: one head block of ``head_frac·n`` entities plus a
    power-law tail with exponent calibrated so the head block holds
    ``pair_share`` of all pairs."""
    head = max(2, int(round(head_frac * n)))
    rest = n - head
    head_pairs = head * (head - 1) // 2

    def tail_sizes(a: float) -> np.ndarray:
        # sizes ∝ k^{-a}, k = 1.., scaled to sum to ``rest``; floor 1,
        # cap at the head size (the head stays the largest block).
        b_guess = max(8, rest // 3)
        w = np.power(np.arange(1, b_guess + 1, dtype=np.float64), -a)
        s = np.maximum(1, np.round(w * (rest / w.sum()))).astype(np.int64)
        s = np.minimum(s, head)
        # trim/extend to hit the exact total
        c = np.cumsum(s)
        cut = int(np.searchsorted(c, rest, side="left")) + 1
        s = s[:cut]
        s[-1] -= int(c[min(cut - 1, len(c) - 1)] - rest)
        if s[-1] <= 0:
            s = s[:-1]
        return s[s > 0]

    # Larger exponent → mass concentrates in the first tail blocks → more
    # tail pairs → lower head share. Bisect a to hit the target share.
    lo_a, hi_a = 0.01, 3.0
    for _ in range(48):
        mid = 0.5 * (lo_a + hi_a)
        s = tail_sizes(mid)
        share = head_pairs / (head_pairs + float((s * (s - 1) // 2).sum()))
        if share > pair_share:
            lo_a = mid       # head too dominant → fatten the tail
        else:
            hi_a = mid
    sizes = np.concatenate([[head], tail_sizes(0.5 * (lo_a + hi_a))])
    assert sizes[0] >= sizes[1:].max(), "head block must stay the largest"
    return sizes.astype(np.int64)


_ALPHABET = "abcdefghijklmnopqrstuvwxyz0123456789"


def _prefixes(count: int) -> Tuple[List[str], int]:
    """``count`` distinct fixed-width prefixes (+ the width used)."""
    width = 3
    while len(_ALPHABET) ** width < count:
        width += 1
    out = []
    for tup in itertools.product(_ALPHABET, repeat=width):
        out.append("".join(tup))
        if len(out) == count:
            return out, width
    raise AssertionError


def _perturb(rng: np.random.Generator, title: str, keep: int = 3) -> str:
    """1-2 char edits after position ``keep`` — preserves the block and
    stays above 0.8 normalized similarity for typical title lengths."""
    s = list(title)
    for _ in range(int(rng.integers(1, 3))):
        op = int(rng.integers(0, 3))
        pos = keep + int(rng.integers(0, max(1, len(s) - keep)))
        ch = _ALPHABET[int(rng.integers(0, 26))]
        if op == 0 and len(s) > 12:
            del s[min(pos, len(s) - 1)]
        elif op == 1:
            s.insert(min(pos, len(s)), ch)
        else:
            s[min(pos, len(s) - 1)] = ch
    return "".join(s)


def _build(name: str, n: int, head_frac: float, pair_share: float,
           seed: int, dup_frac: float) -> Dataset:
    rng = np.random.default_rng(seed)
    base = int(n / (1 + dup_frac))
    sizes = skewed_block_sizes(base, head_frac, pair_share, rng)
    prefixes, width = _prefixes(len(sizes))
    titles: List[str] = []
    for blk, size in enumerate(sizes):
        pre = prefixes[blk]
        w = rng.integers(0, len(_WORDS), (size, 2))
        serial = rng.integers(0, 10_000, size)
        titles.extend(
            f"{pre} {_WORDS[a]} {_WORDS[b]} {v:04d}"
            for a, b, v in zip(w[:, 0], w[:, 1], serial))

    n_dup = int(len(titles) * dup_frac)
    dup_src = rng.choice(len(titles), size=n_dup, replace=False)
    pairs: Set[Tuple[int, int]] = set()
    for src in dup_src:
        titles.append(_perturb(rng, titles[int(src)], keep=width))
        pairs.add((int(src), len(titles) - 1))

    perm = rng.permutation(len(titles))       # arbitrary input order
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    shuffled = [titles[int(i)] for i in perm]
    pairs = {tuple(sorted((int(inv[a]), int(inv[b])))) for a, b in pairs}
    return Dataset(name=name, titles=shuffled, true_pairs=pairs,
                   prefix_len=width)


def make_products(n: int = 114_000, seed: int = 0, dup_frac: float = 0.05) -> Dataset:
    """DS1-like: one block dominates with ~71% of all pairs (Fig. 8)."""
    return _build("DS1-products", n, head_frac=0.018, pair_share=0.71,
                  seed=seed, dup_frac=dup_frac)


def make_publications(n: int = 1_390_000, seed: int = 1, dup_frac: float = 0.03) -> Dataset:
    """DS2-like: largest block ≈ 4% of entities / 26% of pairs (Fig. 8)."""
    return _build("DS2-publications", n, head_frac=0.04, pair_share=0.26,
                  seed=seed, dup_frac=dup_frac)

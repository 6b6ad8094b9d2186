"""Entity featurization.

Two encodings per entity title:

  * ``encode_titles`` — fixed-length uint8 char codes (+ lengths), the
    input to the exact edit-distance verifier (the paper's matcher).
  * ``ngram_features`` — L2-normalized hashed character-n-gram count
    vectors. Cosine similarity over these is a pure matmul, i.e. MXU
    work — the production filter stage in front of the verifier
    (DESIGN.md §2 "Edit distance on MXU").

Hashing is FNV-1a over the n-gram bytes — deterministic across runs and
processes (no PYTHONHASHSEED dependence), vectorized in numpy.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["encode_titles", "ngram_features"]

_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)


def encode_titles(titles: Sequence[str], max_len: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """(n, max_len) uint8 char codes (0-padded) and (n,) int32 lengths."""
    n = len(titles)
    out = np.zeros((n, max_len), np.uint8)
    lens = np.zeros(n, np.int32)
    for i, t in enumerate(titles):
        raw = t.encode("utf-8", errors="replace")[:max_len]
        out[i, : len(raw)] = np.frombuffer(raw, np.uint8)
        lens[i] = len(raw)
    return out, lens


def _fnv1a_rows(mat: np.ndarray) -> np.ndarray:
    """Row-wise FNV-1a over a (rows, n) uint8 matrix -> (rows,) uint64."""
    with np.errstate(over="ignore"):
        h = np.full(mat.shape[0], _FNV_OFFSET, np.uint64)
        for c in range(mat.shape[1]):
            h = (h ^ mat[:, c].astype(np.uint64)) * _FNV_PRIME
    return h


def ngram_features(
    titles: Sequence[str] | np.ndarray,
    dim: int = 256,
    n: int = 3,
    max_len: int = 64,
    lengths: np.ndarray | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Hashed char n-gram count features, L2-normalized. (num, dim).

    Accepts raw strings or a pre-encoded (num, max_len) uint8 matrix (with
    ``lengths``). Titles shorter than ``n`` fall back to a single hash of
    the whole (padded) title so no row is all-zero.
    """
    if isinstance(titles, np.ndarray):
        codes, lens = titles, np.asarray(lengths, np.int64)
    else:
        codes, lens = encode_titles(titles, max_len=max_len)
        lens = lens.astype(np.int64)
    num, L = codes.shape
    feats = np.zeros((num, dim), dtype)
    if L >= n:
        # All n-gram windows as a (num, L-n+1, n) strided view.
        windows = np.lib.stride_tricks.sliding_window_view(codes, n, axis=1)
        ngrams = windows.reshape(num * windows.shape[1], n)
        buckets = (_fnv1a_rows(ngrams) % np.uint64(dim)).astype(np.int64)
        buckets = buckets.reshape(num, windows.shape[1])
        # Window w is valid iff w + n <= len(title).
        valid = (np.arange(windows.shape[1])[None, :] + n) <= lens[:, None]
        rows = np.repeat(np.arange(num), windows.shape[1])
        np.add.at(feats, (rows[valid.ravel()], buckets.ravel()[valid.ravel()]), 1.0)
    short = lens < n
    if short.any():
        h = (_fnv1a_rows(codes[short]) % np.uint64(dim)).astype(np.int64)
        feats[np.flatnonzero(short), h] += 1.0
    norms = np.linalg.norm(feats, axis=1, keepdims=True)
    return (feats / np.maximum(norms, 1e-12)).astype(dtype)

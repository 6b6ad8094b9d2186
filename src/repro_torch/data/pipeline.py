"""Synthetic LM data pipeline for the example launchers and smoke tests.

Generates a deterministic token stream with enough structure that the
cross-entropy visibly falls within a few hundred steps (a first-order
Markov chain over the vocab), packed into (batch, seq) with next-token
labels. Document lengths are Zipf-skewed so the LPT packer has real skew
to balance — the data-pipeline face of the paper's problem.

A numpy copy of ``repro.data.pipeline``: a seed gives the reference's
batches bit for bit.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from .packing import pack_documents

__all__ = ["synthetic_lm_batches"]


def synthetic_lm_batches(vocab: int, batch: int, seq: int, seed: int = 0,
                         markov_temp: float = 0.3) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    # sparse-ish Markov transition table: each token has 8 likely successors
    succ = rng.integers(0, vocab, (vocab, 8))
    while True:
        docs = []
        total = 0
        while total < batch * seq:
            ln = min(int(rng.zipf(1.7) * 32), 4 * seq)   # skewed doc lengths
            t = np.empty(ln, np.int32)
            t[0] = rng.integers(0, vocab)
            for i in range(1, ln):
                if rng.random() < 1 - markov_temp:
                    t[i] = succ[t[i - 1], rng.integers(0, 8)]
                else:
                    t[i] = rng.integers(0, vocab)
            docs.append(t)
            total += ln + 1
        tokens, mask = pack_documents(docs, batch, seq + 1)
        labels = np.where(mask[:, 1:], tokens[:, 1:], -100).astype(np.int32)
        yield {"tokens": tokens[:, :-1].astype(np.int32), "labels": labels}

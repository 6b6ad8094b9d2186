"""Skew-aware sequence packing — the paper's LPT assignment reused at the
data-pipeline layer (DESIGN.md §2): documents are "match tasks" weighted
by token count, microbatch rows are "reduce tasks", and greedy LPT packs
variable-length documents into equal-token rows. The same skew problem —
a few huge documents starving the batch — and the same fix.

A numpy copy of ``repro.data.packing`` on the port's
``core.assignment.greedy_lpt``: a seed packs the reference's rows bit for
bit.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..core.assignment import greedy_lpt, makespan_stats

__all__ = ["lpt_pack", "pack_documents"]


def lpt_pack(doc_lengths: Sequence[int], n_rows: int) -> Tuple[np.ndarray, dict]:
    """Assign docs to rows by greedy LPT over token counts.

    Returns (row_of_doc (n_docs,), balance stats)."""
    w = np.asarray(doc_lengths, np.int64)
    assignment, loads = greedy_lpt(w, n_rows)
    return assignment, makespan_stats(loads)


def pack_documents(docs: List[np.ndarray], n_rows: int, row_len: int,
                   pad_id: int = 0, eos_id: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Pack token arrays into (n_rows, row_len) with LPT balancing.

    Docs overflowing their row are truncated (counted in stats); rows are
    padded with ``pad_id``. Returns (tokens, loss_mask) — mask excludes
    padding and the EOS separators' successors crossing document bounds.
    """
    lengths = [len(d) + 1 for d in docs]  # +1 for EOS separator
    assignment, _ = lpt_pack(lengths, n_rows)
    tokens = np.full((n_rows, row_len), pad_id, np.int32)
    mask = np.zeros((n_rows, row_len), bool)
    cursor = np.zeros(n_rows, np.int64)
    for doc, row in zip(docs, assignment):
        r = int(row)
        take = min(len(doc), row_len - int(cursor[r]) - 1)
        if take <= 0:
            continue
        lo = int(cursor[r])
        tokens[r, lo:lo + take] = doc[:take]
        tokens[r, lo + take] = eos_id
        mask[r, lo:lo + take + 1] = True
        cursor[r] += take + 1
    return tokens, mask

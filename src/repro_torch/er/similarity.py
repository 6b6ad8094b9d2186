"""Stage-2 verifier: exact normalized edit distance on candidate pairs, in
PyTorch on the device the codes live on.

Port of ``repro.er.similarity.edit_distance`` / ``edit_similarity`` with
the same anti-diagonal-free DP: each DP row update is

    c[j]   = min(prev[j] + 1, prev[j-1] + subst_cost[j])
    new[j] = min(c[j], min_{k<j}(c[k] + (j - k)))
           = min(c[j], cummin(c - iota) + iota)

so the sequential insert chain becomes one ``torch.cummin`` over the row;
a Python loop runs the L row steps, batched over all pairs. Rows past a
pair's a-length are frozen and the distance is read at its b-length.
"""
from __future__ import annotations

import torch

__all__ = ["edit_distance", "edit_similarity", "edit_distance_np"]


def edit_distance(a_codes, a_len, b_codes, b_len):
    """Levenshtein distance for each row pair.

    a_codes, b_codes: (P, L) uint8 (0-padded); a_len, b_len: (P,) int32,
    all on one device. Returns (P,) int32 on that device.
    """
    p, length = a_codes.shape
    iota = torch.arange(length + 1, dtype=torch.int32, device=a_codes.device)
    dp = iota.expand(p, length + 1).clone()
    a_len = a_len.to(torch.int32)[:, None]
    for i in range(length):
        subst = (a_codes[:, i:i + 1] != b_codes).to(torch.int32)
        c = torch.cat([dp[:, :1] + 1,
                       torch.minimum(dp[:, 1:] + 1, dp[:, :-1] + subst)], 1)
        new = torch.minimum(c, torch.cummin(c - iota, dim=1).values + iota)
        dp = torch.where(i < a_len, new, dp)
    return dp.gather(1, b_len.to(torch.int64)[:, None])[:, 0]


def edit_similarity(a_codes, a_len, b_codes, b_len):
    """Normalized similarity 1 − dist / max(len_a, len_b) ∈ [0, 1], f32."""
    d = edit_distance(a_codes, a_len, b_codes, b_len).to(torch.float32)
    mx = torch.clamp(torch.maximum(a_len, b_len), min=1).to(torch.float32)
    return 1.0 - d / mx


def edit_distance_np(a: str, b: str) -> int:
    """Plain O(len_a · len_b) reference used by tests."""
    la, lb = len(a), len(b)
    dp = list(range(lb + 1))
    for i in range(1, la + 1):
        prev = dp[0]
        dp[0] = i
        for j in range(1, lb + 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1, prev + (a[i - 1] != b[j - 1]))
            prev = cur
    return dp[lb]

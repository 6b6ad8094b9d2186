"""Peaks of the card and the work that stage 1's inputs need.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W limit). The catalog kernel multiplies float32
features on the FMA units (no TF32), so its operations are priced at
the float32 rate outside the tensor cores.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

PEAKS = {"NVIDIA H100": {"f32_flops": 67e12, "hbm_bytes": 3.35e12}}
SURVIVOR_BYTES = 8        # one survivor written once: two int32 indices


def peak(device_name: str) -> Dict[str, float]:
    for key, value in PEAKS.items():
        if device_name.startswith(key):
            return value
    raise KeyError(f"no peaks for {device_name!r}")


def stage1_cost(live_pairs: int, rows: int, survivors: int,
                feature_dim: int) -> Tuple[float, float]:
    """(operations, bytes) that stage 1 needs: a multiply and an add per
    feature of every live pair; every entity row the jobs touch read
    once in float32, and every survivor written once."""
    flops = 2.0 * feature_dim * live_pairs
    nbytes = 4.0 * feature_dim * rows + SURVIVOR_BYTES * survivors
    return flops, nbytes


def least_time(flops: float, nbytes: float, device_name: str
               ) -> Tuple[float, str]:
    """The least time the card could take, and the term that binds."""
    p = peak(device_name)
    t_ops, t_bytes = flops / p["f32_flops"], nbytes / p["hbm_bytes"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def share_pct(least_s: float, kernel_s: float) -> Optional[float]:
    """The kernel's share of its roofline, or None without a kernel time."""
    if kernel_s <= 0:
        return None
    return 100.0 * least_s / kernel_s

"""Compatibility shims for the tile-catalog executor.

Port of ``repro.er.executor``. The plan → catalog → schedule → execute
pipeline lives in ``er/compiler``; this module keeps the historical entry
points — the per-strategy ``catalog_for_*`` builders, ``build_catalog``,
``score_catalog`` / ``verify_pairs`` / ``match_catalog`` and the
pair-enumeration test oracle — as thin re-exports.
"""
from __future__ import annotations

from .compiler import (  # noqa: F401
    A_TILE, B_TILE, R0, R1, C0, C1, TRI, LB_R, LB_C, UB_R, UB_C, BAND, RED,
    NCOLS,
    TileCatalog,
    cross_job,
    enumerate_catalog_pairs,
    lower,
    match_catalog,
    plan_to_job,
    score_catalog,
    verify_pairs,
)
from .compiler.ir import NO_LB as _NO_LB, NO_UB as _NO_UB  # noqa: F401
from .compiler.lower import pad_catalog as pad_catalog_tiles  # noqa: F401

__all__ = [
    "TileCatalog",
    "catalog_for_basic",
    "catalog_for_block_split",
    "catalog_for_pair_range",
    "catalog_for_sorted_neighborhood",
    "catalog_for_cross",
    "catalog_for_two_source",
    "build_catalog",
    "pad_catalog_tiles",
    "score_catalog",
    "verify_pairs",
    "match_catalog",
    "enumerate_catalog_pairs",
]


def build_catalog(plan, block_m: int = 128, block_n: int = 128) -> TileCatalog:
    """Compile any plan (Basic / BlockSplit / PairRange / SN / 2src) to a
    tile catalog — ``lower(plan_to_job(plan))``."""
    return lower(plan_to_job(plan), block_m, block_n)


def catalog_for_cross(n_a: int, n_b: int, r: int = 1, block_m: int = 128,
                      block_n: int = 128) -> TileCatalog:
    """Full cartesian A × B (the match_⊥(R, R_∅) job)."""
    return lower(cross_job(n_a, n_b, r), block_m, block_n)


# Per-strategy aliases: every one is the same lowering now.
catalog_for_basic = build_catalog
catalog_for_block_split = build_catalog
catalog_for_pair_range = build_catalog
catalog_for_sorted_neighborhood = build_catalog
catalog_for_two_source = build_catalog

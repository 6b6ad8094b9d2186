"""Host planning and featurization of the port against the JAX package:
plans, MatchJobs, catalogs, exact tile costs and schedules must be
array-equal on random BDMs (hypothesis included); codes, lengths, block
ids, features and generated datasets must be bit-identical."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.er.blocking as jblocking  # noqa: E402
import repro.er.compiler as jcompiler  # noqa: E402
import repro.er.datasets as jdatasets  # noqa: E402
import repro.er.encode as jencode  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.er.blocking as tblocking  # noqa: E402
import repro_torch.er.compiler as tcompiler  # noqa: E402
import repro_torch.er.datasets as tdatasets  # noqa: E402
import repro_torch.er.encode as tencode  # noqa: E402
from repro_torch.core import enumeration as ten  # noqa: E402

GEOMETRIES = [(32, 32), (32, 64), (128, 128)]
PLANNERS = ["plan_basic", "plan_block_split", "plan_pair_range"]


def assert_same(got, want):
    """Field-by-field equality of plans / jobs / catalogs / schedules."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__
        for f in dataclasses.fields(want):
            assert_same(getattr(got, f.name), getattr(want, f.name))
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_same(got[k], want[k])
    else:
        assert got == want


def _bdm(seed, b=12, m=4):
    rng = np.random.default_rng(seed)
    bdm = rng.integers(0, 40, (b, m)).astype(np.int64)
    bdm[rng.random(b) < 0.25] = 0          # empty blocks
    bdm[rng.integers(0, b)] = [1] + [0] * (m - 1)  # singleton block
    return bdm


def _same_pipeline(jplan, tplan, r):
    """plan → job → catalog → costs → schedules agree at every step."""
    assert_same(tplan, jplan)
    jjob, tjob = jcompiler.plan_to_job(jplan), tcompiler.plan_to_job(tplan)
    assert_same(tjob, jjob)
    for bm, bn in GEOMETRIES:
        jcat, tcat = jcompiler.lower(jjob, bm, bn), tcompiler.lower(tjob, bm, bn)
        assert_same(tcat, jcat)
        np.testing.assert_array_equal(tcompiler.tile_costs(tcat),
                                      jcompiler.tile_costs(jcat))
        for policy in ("cost_lpt", "round_robin"):
            for n_dev in (1, 3):
                js = jcompiler.schedule_tiles(jcat, n_dev=n_dev, policy=policy)
                ts = tcompiler.schedule_tiles(tcat, n_dev=n_dev, policy=policy)
                assert_same(ts.stats(), js.stats())
                for f in ("tile_cost", "tile_reducer", "reducer_device",
                          "reducer_load", "device_load", "healthy"):
                    np.testing.assert_array_equal(getattr(ts, f),
                                                  getattr(js, f))
                assert_same(tcompiler.apply_schedule(tcat, ts),
                            jcompiler.apply_schedule(jcat, js))


@pytest.mark.parametrize("planner", PLANNERS)
@pytest.mark.parametrize("seed", [3, 7])
def test_plans_catalogs_schedules_equal(planner, seed):
    bdm = _bdm(seed)
    _same_pipeline(getattr(jcore, planner)(bdm, 5),
                   getattr(tcore, planner)(bdm, 5), 5)
    if planner == "plan_pair_range":
        assert tcore.map_output_size(tcore.plan_pair_range(bdm, 5)) == \
            jcore.map_output_size(jcore.plan_pair_range(bdm, 5))


@pytest.mark.parametrize("n,w,r", [(300, 17, 7), (130, 64, 3), (50, 2, 5)])
def test_sorted_neighborhood_equal(n, w, r):
    from repro.core.sorted_neighborhood import map_output_size as jm
    from repro_torch.core.sorted_neighborhood import map_output_size as tm
    jp = jcore.plan_sorted_neighborhood(n, w, r)
    tp = tcore.plan_sorted_neighborhood(n, w, r)
    _same_pipeline(jp, tp, r)
    assert tm(tp) == jm(jp)


def test_two_source_and_cross_jobs_equal():
    rng = np.random.default_rng(1)
    bdm_r = rng.integers(0, 20, (6, 2))
    bdm_s = rng.integers(0, 9, (6, 2))
    jb = jcore.TwoSourceBDM(bdm_r=bdm_r, bdm_s=bdm_s)
    tb = tcore.TwoSourceBDM(bdm_r=bdm_r, bdm_s=bdm_s)
    for name in ("plan_pair_range_2src", "plan_block_split_2src"):
        _same_pipeline(getattr(jcore, name)(jb, 4), getattr(tcore, name)(tb, 4),
                       4)
    for n_a, n_b, r in ((70, 23, 3), (5, 0, 2), (300, 7, 8)):
        jj, tj = jcompiler.cross_job(n_a, n_b, r), tcompiler.cross_job(n_a, n_b, r)
        assert_same(tj, jj)
        for bm, bn in GEOMETRIES:
            assert_same(tcompiler.lower(tj, bm, bn), jcompiler.lower(jj, bm, bn))


sizes_strategy = st.lists(st.integers(0, 60), min_size=1, max_size=25)


@given(sizes_strategy, st.integers(1, 12), st.integers(1, 3))
@settings(max_examples=30, deadline=None)
def test_random_bdm_pipelines_equal(sizes, r, m):
    sizes = np.asarray(sizes, np.int64)
    bdm = np.repeat((sizes // m)[:, None], m, axis=1)
    bdm[:, 0] += sizes % m                  # m partitions, rows sum to sizes
    for planner in PLANNERS:
        jp, tp = getattr(jcore, planner)(bdm, r), getattr(tcore, planner)(bdm, r)
        assert_same(tp, jp)
        jcat = jcompiler.lower(jcompiler.plan_to_job(jp), 32, 32)
        tcat = tcompiler.lower(tcompiler.plan_to_job(tp), 32, 32)
        assert_same(tcat, jcat)
        np.testing.assert_array_equal(tcompiler.tile_costs(tcat),
                                      jcompiler.tile_costs(jcat))
        js, ts = jcompiler.schedule_tiles(jcat), tcompiler.schedule_tiles(tcat)
        np.testing.assert_array_equal(ts.tile_reducer, js.tile_reducer)


@pytest.mark.parametrize("law", [(20_000, 0.04, 0.26), (6_000, 0.018, 0.71),
                                 (400, 0.5, 0.9)])
@pytest.mark.parametrize("r", [1, 7, 32, 200])
def test_pair_range_segments_equal(law, r):
    """PairRange's per-range block segments (one elementwise inversion a
    range in the port) and the gather intervals and map-output size built
    on them equal the JAX package's, on the DS2 and DS1 block laws and
    with more ranges than some blocks have pairs."""
    sizes = _law_sizes(*law)
    bdm = np.repeat((sizes // 3)[:, None], 3, axis=1)
    bdm[:, 0] += sizes % 3
    jp, tp = jcore.plan_pair_range(bdm, r), tcore.plan_pair_range(bdm, r)
    for k in range(r):
        assert tcore.pair_range.range_block_segments(tp, k) == \
            jcore.pair_range.range_block_segments(jp, k)
        assert tcore.range_block_intervals(tp, k) == \
            jcore.range_block_intervals(jp, k)
    assert tcore.pair_range.map_output_size(tp) == \
        jcore.pair_range.map_output_size(jp)


def _law_sizes(n, head_frac, pair_share):
    """Block sizes of a skewed law: a head block, a power-law tail and
    some blocks of one entity (no pairs)."""
    rng = np.random.default_rng(n)
    head = int(head_frac * n)
    tail = np.maximum(1, (n * pair_share / 40 / np.arange(1, n // 8)
                          ** 0.9).astype(np.int64))
    sizes = np.concatenate([[head], tail, np.ones(50, np.int64)])
    return sizes[rng.permutation(sizes.size)]


@given(sizes_strategy)
@settings(max_examples=40, deadline=None)
def test_port_pair_index_bijection(sizes):
    """The port's own enumeration math (a copy, tested on its own):
    global pair_index bijects onto [0, P) across any block sizes."""
    sizes = np.asarray(sizes, np.int64)
    offsets, total = ten.pair_offsets(ten.block_pair_counts(sizes))
    if total == 0:
        return
    p = np.arange(total, dtype=np.int64)
    blk, x, y = ten.invert_pair_index(p, sizes, offsets)
    assert (x < y).all() and (y < sizes[blk]).all()
    np.testing.assert_array_equal(ten.pair_index(blk, x, y, sizes, offsets), p)


@given(st.integers(1, 300), st.integers(1, 8), st.integers(1, 16),
       st.integers(0, 2 ** 31 - 1))
@settings(max_examples=30, deadline=None)
def test_port_catalog_costs_count_planned_pairs(n, m, r, seed):
    """Exact tile costs of the port's catalogs sum to the planned pairs,
    for every strategy, on Zipf-skewed BDMs."""
    rng = np.random.default_rng(seed)
    blocks = (rng.zipf(1.5, size=n) - 1) % max(n // 4, 1)
    bdm = tcore.compute_bdm(blocks, rng.integers(0, m, n),
                            int(blocks.max()) + 1, m)
    for planner in PLANNERS:
        plan = getattr(tcore, planner)(bdm, r)
        cat = tcompiler.lower(tcompiler.plan_to_job(plan), 32, 64)
        assert int(tcompiler.tile_costs(cat).sum()) == plan.total_pairs


@pytest.mark.parametrize("maker,n,seed", [("make_products", 3000, 0),
                                          ("make_products", 1200, 11),
                                          ("make_publications", 2000, 1)])
def test_datasets_and_features_bit_identical(maker, n, seed):
    jd, td = getattr(jdatasets, maker)(n, seed=seed), getattr(tdatasets, maker)(n, seed=seed)
    assert td.titles == jd.titles and td.true_pairs == jd.true_pairs
    assert td.prefix_len == jd.prefix_len
    titles = td.titles + ["", "  ", "ab", "é€ unicode title"]
    for max_len in (48, 64):
        jc, jl = jencode.encode_titles(titles, max_len=max_len)
        tc, tl = tencode.encode_titles(titles, max_len=max_len)
        assert_same(tc, jc)
        assert_same(tl, jl)
        for dim in (128, 200, 256):
            jf = jencode.ngram_features(jc, dim=dim, lengths=jl)
            tf = tencode.ngram_features(tc, dim=dim, lengths=tl)
            assert jf.dtype == tf.dtype and jf.tobytes() == tf.tobytes()
    jb, jn = jblocking.prefix_block_ids(titles)
    tb, tn = tblocking.prefix_block_ids(titles)
    assert_same(tb, jb)
    assert tn == jn
    assert_same(tblocking.sn_sort_order(titles), jblocking.sn_sort_order(titles))
    rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
    assert_same(tblocking.exponential_block_ids(n, 30, 1.0, rng_t),
                jblocking.exponential_block_ids(n, 30, 1.0, rng_j))
    keyed = jb >= 0
    part = np.minimum(np.arange(keyed.sum()) * 4 // keyed.sum(), 3)
    jbdm = jcore.compute_bdm(jb[keyed], part, int(jb.max()) + 1, 4)
    tbdm = tcore.compute_bdm(tb[keyed], part, int(tb.max()) + 1, 4)
    assert_same(tbdm, jbdm)
    je = jcore.entity_indices(jb[keyed], part, jbdm)
    te = tcore.entity_indices(tb[keyed], part, tbdm)
    assert_same(te, je)
    sizes = tbdm.sum(axis=1)
    for got, want in zip(tcore.blocked_layout(tb[keyed], te, sizes),
                         jcore.blocked_layout(jb[keyed], je, sizes)):
        assert_same(got, want)
    assert_same(tcore.update_bdm(tbdm, tb[keyed][:50], part[:50]),
                jcore.update_bdm(jbdm, jb[keyed][:50], part[:50]))

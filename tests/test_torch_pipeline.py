"""The whole slice on the CPU: the port's ``run_er(device="cpu")`` on the
catalog executor against the JAX package's ``run_er`` (XLA twin of the
catalog kernels) — equal matches, total_pairs, map_output_size,
reducer_pairs and schedule, for every strategy, with and without key-less
titles, plus a capacity-4 leg that forces the mask fallback. Also the
options that belong to later slices, and the no-card rule."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.er as jer  # noqa: E402
import repro_torch.er as ter  # noqa: E402
from repro_torch.er.compiler import stage1_stats  # noqa: E402
from torch_parity import keyless, skewed_corpus  # noqa: E402

BLOCKED = ("basic", "block_split", "pair_range")
BASE = dict(r=8, m=4, feature_dim=128, max_len=48, block_m=32, block_n=64)
SN = dict(strategy="sorted_neighborhood", window=12, r=8, feature_dim=128,
          max_len=48)


@pytest.fixture(scope="module")
def skewed():
    return skewed_corpus()


def assert_same_result(got, want):
    assert got.matches == want.matches
    assert got.total_pairs == want.total_pairs
    assert got.map_output_size == want.map_output_size
    np.testing.assert_array_equal(got.reducer_pairs, want.reducer_pairs)
    assert got.schedule == want.schedule
    assert got.extra.get("catalog_tiles") == want.extra.get("catalog_tiles")
    assert got.extra.get("null_key_pairs") == want.extra.get("null_key_pairs")


@pytest.mark.parametrize("strategy", BLOCKED)
@pytest.mark.parametrize("with_keyless", [False, True])
def test_catalog_run_er_equals_reference_package(skewed, strategy,
                                                 with_keyless):
    titles, bid = keyless(*skewed) if with_keyless else skewed
    got = ter.run_er(titles, ter.ERConfig(strategy=strategy, **BASE),
                     block_ids=bid, device="cpu")
    want = jer.run_er(titles, jer.ERConfig(strategy=strategy,
                                           kernel_impl="xla", **BASE),
                      block_ids=bid)
    assert_same_result(got, want)
    assert len(got.matches) > 0
    if with_keyless:
        assert got.extra["null_key_pairs"] > 0


@pytest.mark.parametrize("with_keyless", [False, True])
def test_sorted_neighborhood_run_er_equals_reference_package(skewed,
                                                             with_keyless):
    titles = keyless(*skewed)[0] if with_keyless else skewed[0]
    got = ter.run_er(titles, ter.ERConfig(**SN), device="cpu")
    want = jer.run_er(titles, jer.ERConfig(kernel_impl="xla", **SN))
    assert_same_result(got, want)
    assert got.extra["w_eff"] == want.extra["w_eff"]


def test_capacity_four_forces_the_exact_mask_fallback(skewed):
    titles, bid = skewed
    before = dict(stage1_stats)
    got = ter.run_er(titles, ter.ERConfig(compact_capacity=4, **BASE),
                     block_ids=bid, device="cpu")
    assert stage1_stats["compact_overflows"] > before["compact_overflows"]
    assert stage1_stats["nonzero_decodes"] > before["nonzero_decodes"]
    want = jer.run_er(titles, jer.ERConfig(kernel_impl="xla",
                                           compact_capacity=4, **BASE),
                      block_ids=bid)
    assert_same_result(got, want)


@pytest.mark.parametrize("option", [
    dict(mesh=object()), dict(fault_injector=object()),
    dict(feedback=object()), dict(config=dict(supervised_devices=2)),
    dict(config=dict(tune_tiles=True)), dict(config=dict(comms="ring"))])
def test_later_slices_raise_not_implemented(option):
    kwargs = dict(option)
    cfg = ter.ERConfig(**kwargs.pop("config", {}))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        ter.run_er(["abc def", "abc deg"], cfg, device="cpu", **kwargs)


def test_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ter.run_er(["abc def", "abc deg"])
    cat = ter.lower(ter.cross_job(4, 4), 32, 32)
    feats = np.ones((4, 8), np.float32)
    for fn in (lambda: ter.score_catalog(feats, cat, threshold=0.5),
               lambda: ter.execute(cat, feats, threshold=0.5)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    with pytest.raises(ValueError, match="kernel_impl"):
        ter.run_er(["abc"], ter.ERConfig(kernel_impl="xla"), device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ter.run_er(["abc def", "abc deg"], ter.ERConfig(kernel_impl="cuda"),
                   device="cpu")


@pytest.mark.parametrize("strategy", BLOCKED + ("sorted_neighborhood",))
def test_plan_job_and_compile_catalog_equal_reference_package(skewed,
                                                              strategy):
    """Job 1 + plan and the scheduled catalog, as ``run_er`` makes them,
    against the JAX package's planner and compiler on the same input."""
    import repro.core as jcore
    import repro.er.compiler as jc
    from repro.er.blocking import sn_sort_order

    titles, bid = keyless(*skewed)
    sn = strategy == "sorted_neighborhood"
    cfg = ter.ERConfig(**SN) if sn else ter.ERConfig(strategy=strategy,
                                                     **BASE)
    jp = ter.plan_job(titles, cfg, bid)
    cat, sched = ter.compile_catalog(jp.plan, cfg)

    if sn:
        to_global = sn_sort_order(titles)
        jplan = jcore.plan_sorted_neighborhood(len(titles), cfg.window, cfg.r)
        assert jp.null_idx is None
    else:
        keyed = np.flatnonzero(bid >= 0)
        part = np.minimum(np.arange(len(titles)) * cfg.m // len(titles),
                          cfg.m - 1)[keyed]
        kb = np.asarray(bid, np.int64)[keyed]
        bdm = jcore.compute_bdm(kb, part, int(kb.max()) + 1, cfg.m)
        perm, _ = jcore.blocked_layout(
            kb, jcore.entity_indices(kb, part, bdm), bdm.sum(axis=1))
        to_global = keyed[perm]
        jplan = {"basic": jcore.plan_basic, "block_split":
                 jcore.plan_block_split, "pair_range":
                 jcore.plan_pair_range}[strategy](bdm, cfg.r)
        np.testing.assert_array_equal(jp.null_idx,
                                      np.flatnonzero(bid < 0))
    np.testing.assert_array_equal(jp.to_global, to_global)
    assert jp.plan.total_pairs == jplan.total_pairs
    jcat = jc.lower(jc.plan_to_job(jplan), cfg.block_m, cfg.block_n)
    jsched = jc.schedule_tiles(jcat, n_dev=1, policy=cfg.schedule_policy)
    np.testing.assert_array_equal(cat.tiles,
                                  jc.apply_schedule(jcat, jsched).tiles)
    assert sched.stats() == jsched.stats()

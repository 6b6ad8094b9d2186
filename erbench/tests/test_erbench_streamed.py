"""The streamed reference and the ``batch_streamed`` driver on the CPU: the
reference gives ``check.batch_expected``'s survivor keys, band keys,
matches and band pairs (the comparison leaves the band out, so the parts
are held equal up to it) on the DS2 and DS1 laws and with key-less
titles, at a group larger and one smaller than a block, in float64 and
in TF32; the driver's hashes and numbers are the check's; the new cell
runs in a layout of its own files and is correct, traced and untraced;
a dropped survivor or an altered match makes it not correct. On the
card (``-m gpu``): the driver at 50,000 titles of the DS2 law."""
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from erbench import check
from erbench.data import make_corpus
from erbench.drivers import batch_streamed
from erbench.harness import Layout, make_cell, run_cell
from erbench.reference import streamed
from erbench.tests.helpers import small_cell
from repro_torch.er import pipeline

ROOT = Path(__file__).resolve().parents[2]
CELL = "ds2_publications_dedup.batch_pair_range_streamed"
CONF = json.loads((ROOT / "erbench" / "configs"
                   / "ds2_publications_dedup.json").read_text())
DS1 = json.loads((ROOT / "erbench" / "configs"
                  / "ds1_products.json").read_text())
SEED = 2 ** 33 + 5


def _corpus(law, n, keyless=False):
    c = make_corpus(dict(law["data"], n=n), SEED)
    titles = list(c.titles)
    if keyless:
        titles = ["" if i % 97 == 0 else t for i, t in enumerate(titles)]
        titles += ["  ", "xyz"]
    return titles, dict(law["run_er"], prefix_len=c.key_width)


def _assert_same(got, want):
    """Equal in all four parts, up to the band pairs the check leaves
    out: a cosine at the threshold may round either way in float64."""
    assert np.array_equal(np.sort(got["band_keys"]),
                          np.sort(want["band_keys"]))
    assert got["band_pairs"] == want["band_pairs"]
    assert check.multiset_diff(got["survivors"], want["survivors"],
                               want["band_keys"]) == 0
    assert not (got["matches"] ^ want["matches"]) - want["band_pairs"]
    assert got["considered"] == want["considered"]


CASES = [("ds2", 3000, False), ("ds2", 20000, False), ("ds1", 4000, False),
         ("ds2", 3000, True)]


@pytest.mark.parametrize("law,n,keyless", CASES,
                         ids=[f"{a}-{n}{'-keyless' if k else ''}"
                              for a, n, k in CASES])
@pytest.mark.parametrize("precision", ["float64", "tf32"])
def test_streamed_equals_batch_expected(law, n, keyless, precision):
    titles, er = _corpus(CONF if law == "ds2" else DS1, n, keyless)
    want = check.batch_expected(titles, er, "pair_range", "cpu", precision)
    assert want["survivors"].size > 100 and want["matches"]
    for cells in (streamed.GROUP_CELLS, 1 << 10):   # a block is > 2^10
        got = streamed.batch_expected(titles, er, "pair_range", "cpu",
                                      precision, cells=cells)
        _assert_same(got, want)


def test_strips_cover_a_block_larger_than_a_group():
    titles, er = _corpus(CONF, 3000)
    blocks = streamed._blocks(titles, er["prefix_len"])
    assert blocks[2].max() ** 2 > 1 << 10         # the head block strips
    got = streamed.batch_expected(titles, er, "basic", "cpu", cells=64)
    _assert_same(got, check.batch_expected(titles, er, "basic", "cpu"))


def test_only_blocked_strategies():
    with pytest.raises(ValueError, match="blocked"):
        streamed.batch_expected(["a b c"], DS1["run_er"],
                                "sorted_neighborhood", "cpu")


def test_driver_hashes_and_numbers_are_the_checks():
    titles, er = _corpus(CONF, 3000, keyless=True)
    log = check.SurvivorLog()
    with check.record_survivors(log, [pipeline]):
        log.open = True
        res = pipeline.run_er(titles, pipeline.ERConfig(**er), device="cpu")
    calls = log.take()
    assert len(calls) == 2 and calls[0][0] is calls[0][1]
    got = batch_streamed.survivor_hashes(calls)
    want = check.survivor_hashes(calls)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    exp = check.batch_expected(titles, er, "pair_range", "cpu")
    keys = check.pair_keys(*got, ordered=False)
    runs = [{"survivor_hashes": got, "matches": res.matches}]
    broken = {"survivor_hashes": (got[0][1:], got[1][1:]),
              "matches": res.matches | {(0, 1)}}
    for rs in (runs, [broken], runs + [broken], [{"error": "x"}] + runs):
        mine = [dict(r, survivor_keys=check.pair_keys(
            *r["survivor_hashes"], ordered=False)) if "error" not in r
            else r for r in rs]
        assert batch_streamed.window_numbers(mine, exp, "cpu") == \
            check.batch_numbers(rs, exp)
    assert keys.size == sum(np.asarray(c[2]).size for c in calls) > 0


def test_multiset_diff_is_the_checks():
    rng = np.random.default_rng(7)
    for _ in range(200):
        a, b = (rng.integers(0, 16, int(rng.integers(0, 40)))
                for _ in range(2))
        skip = rng.integers(0, 16, int(rng.integers(0, 4)))
        assert batch_streamed.multiset_diff(a, b, skip, "cpu") == \
            check.multiset_diff(a, b, skip)


def test_pair_keys_are_the_checks():
    rng = np.random.default_rng(8)
    ha, hb = (rng.integers(-2 ** 63, 2 ** 63 - 1, 5000, dtype=np.int64)
              for _ in range(2))
    ha[:3] = [-2 ** 63, 2 ** 63 - 1, 0]
    np.testing.assert_array_equal(streamed.pair_keys(ha, hb, "cpu"),
                                  check.pair_keys(ha, hb, ordered=False))
    np.testing.assert_array_equal(streamed.pair_keys(hb, ha, "cpu"),
                                  check.pair_keys(ha, hb, ordered=False))


def _layout(tmp_path):
    """The benchmark's data files under ``tmp_path``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for d in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(ROOT / "erbench" / d, tmp_path / "erbench" / d)
    return Layout(tmp_path)


SMALL = {"data": {"n": 3000}, "run_er": {"prefix_len": 3}}


def test_the_cell_runs_and_is_correct(tmp_path):
    layout = _layout(tmp_path)
    for trace in (False, True):
        c = make_cell(layout, CELL, 4294967311, 0.3, trace, "cpu",
                      overrides={"config": SMALL})
        out = run_cell(c, time.perf_counter(), layout)
        assert out["correct"], out["check"]
        assert {k: v["value"] for k, v in out["check"].items()} == \
            {"survivor_diff": 0, "match_diff": 0, "failed": 0}
        names = set(out["metrics"])
        if trace:
            assert {"pipeline.collect_s", "stage1.decode_s",
                    "encode.featurize_s", "compiler.lower_s"} <= names
        else:
            assert names == {"batch_entities_per_s", "setup_s"}


def _drop_a_survivor(monkeypatch):
    """Stage 1 loses its most similar pair, a near-duplicate that stage 2
    would match."""
    execute = pipeline.execute

    def dropped(catalog, feats_a, feats_b=None, **k):
        ca, cb = execute(catalog, feats_a, feats_b, **k)
        fb = feats_a if feats_b is None else feats_b
        cos = (feats_a[torch.as_tensor(ca)] * fb[torch.as_tensor(cb)]).sum(1)
        keep = np.ones(ca.size, bool)
        keep[int(cos.argmax())] = False
        return ca[keep], cb[keep]
    monkeypatch.setattr(pipeline, "execute", dropped)


def _alter_a_match(monkeypatch):
    verify = pipeline.verify_pairs

    def altered(*a, **k):
        ha, hb = verify(*a, **k)
        if ha.size:
            ha = ha.copy()
            ha[0] += 1
        return ha, hb
    monkeypatch.setattr(pipeline, "verify_pairs", altered)


@pytest.mark.parametrize("fault", [_drop_a_survivor, _alter_a_match],
                         ids=["survivor_dropped", "match_altered"])
def test_a_broken_run_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run_cell(small_cell(CELL, seconds=0.2, config=SMALL),
                   time.perf_counter())
    assert not out["correct"]
    assert out["check"]["match_diff"]["value"] >= 1
    if fault is _drop_a_survivor:
        assert out["check"]["survivor_diff"]["value"] >= 1


@pytest.mark.gpu
def test_the_driver_on_the_card():
    """The new driver at 50,000 titles of the DS2 law on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = make_cell(Layout(), CELL, 4242424242, 2.0, False, "cuda",
                  overrides={"config": {"data": {"n": 50000},
                                        "run_er": {"prefix_len": 3}}})
    out = run_cell(c, time.perf_counter())
    assert out["correct"], out["check"]
    assert out["device"]["platform"] == "gpu"
    assert out["metrics"]["batch_entities_per_s"]["value"] > 0

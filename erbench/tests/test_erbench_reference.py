"""The plain reference agrees with the program on the CPU at a small size:
features, edit distance, and whole runs of each cell's entry point."""
import numpy as np
import pytest
import torch

from erbench.reference import er as ref
from erbench.tests.helpers import run_small
from repro_torch.er.encode import encode_titles, ngram_features
from repro_torch.er.similarity import edit_distance_np

TITLES = ["", "a", "ab", "abc laptop phone 0042", "abc laptop phone 0043",
          "  Mixed Case Title  ", "é accent", "x" * 80]


def test_features_match_the_program():
    codes, lens = ref.encode(TITLES, 64)
    pc, pl = encode_titles(TITLES, max_len=64)
    assert np.array_equal(codes, pc) and np.array_equal(lens, pl)
    mine = ref.features(codes, lens, 256, "cpu").numpy()
    theirs = ngram_features(pc, dim=256, lengths=pl)
    assert np.abs(mine - theirs).max() < 1e-6


def test_edit_distance_matches_the_textbook():
    rng = np.random.default_rng(3)
    words = ["".join(rng.choice(list("abcde"), int(rng.integers(0, 12))))
             for _ in range(60)]
    a, b = words[:30], words[30:]
    ca, la = ref.encode(a, 64)
    cb, lb = ref.encode(b, 64)
    d = ref.edit_distance(torch.as_tensor(ca), torch.as_tensor(la),
                          torch.as_tensor(cb), torch.as_tensor(lb)).numpy()
    assert d.tolist() == [edit_distance_np(x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("cell", ["ds1_products.batch_pair_range",
                                  "ds1_products.batch_sorted_neighborhood",
                                  "ds1_products.service_closed32",
                                  "ds2_publications.service_closed32"])
def test_small_run_is_correct(cell):
    out = run_small(cell, seconds=0.5)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_key_less_entities_take_the_match_bottom_job():
    """Batch PairRange with titles that have no key: the reference's
    match_⊥ pairs agree with the program's."""
    from erbench import check
    from repro_torch.er import ERConfig, run_er
    titles = ["", " ", "abc laptop phone 0042", "abc laptop phone 0043",
              "abd laptop phone 0042", ""] * 3
    er = {"threshold": 0.8, "filter_margin": 0.25, "prefix_len": 3,
          "feature_dim": 256, "max_len": 64, "window": 10}
    want = check.batch_expected(titles, er, "pair_range", "cpu")
    got = run_er(titles, ERConfig(), device="cpu").matches
    assert check.set_diff(got, want["matches"], want["band_pairs"]) == 0
    assert (0, 5) in got

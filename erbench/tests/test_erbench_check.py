"""The pieces of the comparison: content hashes that tell near-identical
titles apart, multiset and set differences, the verdict."""
import numpy as np
import pytest

from erbench.check import (multiset_diff, pair_keys, row_hash, set_diff,
                           verdict)
from erbench.reference.er import encode

BASE = "oji charger charger 8969"


def _variants():
    """Every title one or two letter substitutions away from ``BASE``
    past its key: the near-duplicates the service's queries are."""
    letters = "aetz"
    one = {BASE[:p] + c + BASE[p + 1:] for p in range(3, len(BASE))
           for c in letters}
    two = {v[:p] + c + v[p + 1:] for v in sorted(one)[::7]
           for p in range(3, len(BASE)) for c in letters}
    return sorted(one | two)


def test_row_hashes_of_near_duplicates_are_distinct():
    titles = _variants()
    h = row_hash(encode(titles, 64)[0])
    assert len(set(h.tolist())) == len(titles) > 500


def test_pair_keys():
    h = row_hash(encode(_variants()[:300], 64)[0])
    a, b = np.repeat(h, 300), np.tile(h, 300)
    assert len(set(pair_keys(a, b, ordered=True).tolist())) == 300 * 300
    assert np.array_equal(pair_keys(a, b, ordered=False),
                          pair_keys(b, a, ordered=False))


def test_multiset_and_set_differences():
    got = np.asarray([1, 1, 2, 5, 7])
    want = np.asarray([1, 2, 2, 6, 7])
    assert multiset_diff(got, want, np.asarray([], np.int64)) == 4
    assert multiset_diff(got, want, np.asarray([5, 6])) == 2
    assert set_diff({(1, 2), (3, 4)}, {(1, 2), (5, 6)}, {(5, 6)}) == 1


@pytest.mark.parametrize("numbers,ok", [
    ({"survivor_diff": 3, "match_diff": 0, "failed": 0}, True),
    ({"survivor_diff": 11, "match_diff": 0, "failed": 0}, False),
    ({"survivor_diff": 0, "match_diff": 1, "failed": 0}, False),
    ({"survivor_diff": 0, "match_diff": 0}, False),
])
def test_verdict(numbers, ok):
    correct, out = verdict(numbers, {"survivor_diff": 10, "match_diff": 0,
                                     "failed": 0})
    assert correct is ok and set(out) == {"survivor_diff", "match_diff",
                                          "failed"}

"""The inputs are a function of the seed: the same seed gives the same
corpus and requests; every seed gives the same blocks and request sizes."""
import collections

import numpy as np

from erbench.data import (NEW_BLOCK_QUERY, NULL_KEY_QUERY, RequestStream,
                          block_sizes, make_corpus)

LAW = {"n": 4000, "head_frac": 0.018, "pair_share": 0.71, "dup_frac": 0.05}
MIX = {"size_min": 1, "size_max": 128, "special_every": 64,
       "null_key_at": 17, "new_block_at": 49}


def _blocks(titles, width):
    return sorted(collections.Counter(t[:width] for t in titles).values())


def test_same_seed_same_corpus():
    a = make_corpus(LAW, 2 ** 31 + 17)
    b = make_corpus(LAW, 2 ** 31 + 17)
    assert a.titles == b.titles and a.key_width == b.key_width == 3


def test_seeds_share_the_block_law():
    a, b = make_corpus(LAW, 1), make_corpus(LAW, 2)
    assert a.titles != b.titles
    base = block_sizes(int(LAW["n"] / 1.05), LAW["head_frac"],
                       LAW["pair_share"])
    for c in (a, b):
        sizes = _blocks(c.titles, c.key_width)
        assert len(sizes) == base.size
        # near-duplicates join their source's block
        assert sum(sizes) == len(c.titles) > base.sum()


def test_requests_are_seeded_and_keep_their_block():
    corpus = make_corpus(LAW, 5).titles
    keys = {t[:3] for t in corpus}
    s1 = RequestStream(corpus, 3, MIX, 99, 0, 256)
    s2 = RequestStream(corpus, 3, MIX, 99, 0, 256)
    s3 = RequestStream(corpus, 3, MIX, 98, 0, 256)
    assert [s1.request(k) for k in range(256)] == \
        [s2.request(k) for k in range(256)]
    assert sorted(s1.sizes) == sorted(s3.sizes) == sorted(
        list(range(1, 129)) * 2)
    assert not np.array_equal(s1.sizes, s3.sizes)
    for k in range(256):
        req = s1.request(k)
        head = req[0]
        if k % 64 == 17:
            assert head == NULL_KEY_QUERY
        elif k % 64 == 49:
            assert head == NEW_BLOCK_QUERY and head[:3] not in keys
        body = req[1:] if k % 64 in (17, 49) else req
        assert all(q[:3] in keys for q in body)

"""The port's stage-2 verifier (torch.cummin DP, and the CUDA kernel's
bit-vector recurrence in its NumPy twin) against the plain O(len_a·len_b)
reference and the JAX package's lax.scan version: integer distances must
be equal exactly, similarities bit for bit, and ``verify_pairs`` must keep
the same pairs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.er.compiler import verify_pairs as j_verify_pairs  # noqa: E402
from repro.er.encode import encode_titles as j_encode  # noqa: E402
from repro.er.similarity import edit_distance as j_edit_distance  # noqa: E402
from repro.er.similarity import edit_similarity as j_edit_similarity  # noqa: E402
from repro_torch.er import make_products  # noqa: E402
from repro_torch.er.compiler import verify_pairs  # noqa: E402
from repro_torch.er.encode import encode_titles  # noqa: E402
from repro_torch.er.similarity import (edit_distance, edit_distance_np,  # noqa: E402
                                       edit_similarity)
from repro_torch.kernels.edit_distance import bitvector_distance_np  # noqa: E402
import torch_parity  # noqa: E402,F401  (one torch thread per test worker)

ALPHABET = list("abcde xyz0")


def _strings(rng, n, max_len):
    lens = rng.integers(0, max_len + 4, n)        # some past max_len
    return ["".join(rng.choice(ALPHABET, k)) for k in lens]


def _perturbed(rng, strings):
    out = []
    for s in strings:
        s = list(s)
        for _ in range(int(rng.integers(0, 4))):
            pos = int(rng.integers(0, len(s) + 1))
            op = int(rng.integers(0, 3))
            if op == 0 and s:
                del s[min(pos, len(s) - 1)]
            elif op == 1:
                s.insert(pos, str(rng.choice(ALPHABET)))
            elif s:
                s[min(pos, len(s) - 1)] = str(rng.choice(ALPHABET))
        out.append("".join(s))
    return out


@pytest.mark.parametrize("max_len,seed", [(16, 0), (48, 1), (64, 2)])
def test_edit_distance_exact(max_len, seed):
    rng = np.random.default_rng(seed)
    a = _strings(rng, 300, max_len)
    b = _perturbed(rng, a[:150]) + _strings(rng, 150, max_len)
    ca, la = encode_titles(a, max_len=max_len)
    cb, lb = encode_titles(b, max_len=max_len)
    got = edit_distance(torch.from_numpy(ca), torch.from_numpy(la),
                        torch.from_numpy(cb), torch.from_numpy(lb))
    assert got.dtype == torch.int32
    want_jax = np.asarray(j_edit_distance(ca, la, cb, lb))
    np.testing.assert_array_equal(got.numpy(), want_jax)
    want_np = [edit_distance_np(x[:max_len], y[:max_len])
               for x, y in zip(a, b)]
    np.testing.assert_array_equal(got.numpy(), want_np)
    sim = edit_similarity(torch.from_numpy(ca), torch.from_numpy(la),
                          torch.from_numpy(cb), torch.from_numpy(lb))
    want_sim = np.asarray(j_edit_similarity(ca, la, cb, lb))
    assert sim.numpy().tobytes() == want_sim.tobytes()


def test_verify_pairs_equals_reference():
    ds = make_products(1500, seed=4)
    codes, lens = encode_titles(ds.titles, max_len=48)
    jc, jl = j_encode(ds.titles, max_len=48)
    rng = np.random.default_rng(4)
    ra = rng.integers(0, len(ds.titles), 20_000)
    rb = rng.integers(0, len(ds.titles), 20_000)
    truth = np.array(sorted(ds.true_pairs))
    ra = np.concatenate([ra, truth[:, 0]])
    rb = np.concatenate([rb, truth[:, 1]])
    got = verify_pairs(codes, lens, codes, lens, ra, rb, 0.8, device="cpu")
    want = j_verify_pairs(jc, jl, jc, jl, ra, rb, 0.8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[0].size >= truth.shape[0]


def test_verify_pairs_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    codes, lens = encode_titles(["abc", "abd"], max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        verify_pairs(codes, lens, codes, lens, np.array([0]), np.array([1]),
                     0.5)


@pytest.mark.parametrize("max_len,seed", [(64, 5), (100, 6)])
def test_bitvector_twin_equals_the_reference(max_len, seed):
    """The CUDA verifier's recurrence (its NumPy twin) against the JAX
    package's lax.scan DP: distances exactly, f32 similarities bit for
    bit."""
    rng = np.random.default_rng(seed)
    a = _strings(rng, 400, max_len)
    b = _perturbed(rng, a[:200]) + _strings(rng, 200, max_len)
    ca, la = encode_titles(a, max_len=max_len)
    cb, lb = encode_titles(b, max_len=max_len)
    d = bitvector_distance_np(ca, la, cb, lb)
    np.testing.assert_array_equal(d, np.asarray(j_edit_distance(ca, la, cb,
                                                                lb)))
    mx = np.maximum(np.maximum(la, lb), 1).astype(np.float32)
    sim = np.float32(1.0) - d.astype(np.float32) / mx
    want = np.asarray(j_edit_similarity(ca, la, cb, lb))
    assert sim.tobytes() == want.tobytes()

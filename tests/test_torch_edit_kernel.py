"""Stage 2's bit-vector verifier (``csrc/edit_distance.cu``) and its
route through ``verify_pairs``.

On the CPU: the kernel's recurrence, in its NumPy twin
(``edit_distance.bitvector_distance_np``, one or more uint64 words), held
to the plain O(la·lb) DP and to the port's PyTorch DP on random pairs and
the edge cases; ``verify_pairs`` choosing the plain route for CPU tensors
and refusing ``impl="cuda"`` there. On the card (marked ``gpu``): the
kernel against the plain route, distances exactly and similarities bit
for bit, and ``verify_pairs`` on the kernel route against
``impl="torch"``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.er.compiler import stage2_stats, verify_pairs  # noqa: E402
from repro_torch.er.similarity import (edit_distance, edit_distance_np,  # noqa: E402
                                       edit_similarity)
from repro_torch.kernels import edit_distance as kernel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
import torch_parity  # noqa: E402,F401  (one torch thread per test worker)

# A few letters (so near copies and long common runs occur), a space and
# bytes >= 0x80, where a signed compare or a sign-extending load would err.
ALPHABET = np.frombuffer(b"abcde xyz0\x80\xc3\xa9\xff", np.uint8)


def _random_pairs(rng, n, length):
    """Row-paired (n, L) codes and lengths: half near copies (a few
    substitutions, the b length moved by up to 3), half independent, with
    random bytes past every length."""
    la = rng.integers(0, length + 1, n).astype(np.int32)
    lb = rng.integers(0, length + 1, n).astype(np.int32)
    ca = rng.choice(ALPHABET, (n, length))
    cb = rng.choice(ALPHABET, (n, length))
    h = n // 2
    cb[:h] = ca[:h]
    flip = rng.random((h, length)) < 0.08
    cb[:h][flip] = rng.choice(ALPHABET, int(flip.sum()))
    lb[:h] = np.clip(la[:h] + rng.integers(-3, 4, h), 0, length)
    return ca, la, cb, lb


def _edge_pairs(length):
    """Empty rows, length 1, length exactly 64 and exactly L, equal rows,
    rows of one repeated byte, bytes >= 0x80, codes differing only past
    the length."""
    rows = []

    def add(a, b, pad_a=0, pad_b=0):
        ra = np.full(length, pad_a, np.uint8)
        rb = np.full(length, pad_b, np.uint8)
        ra[:len(a)] = np.frombuffer(a, np.uint8)
        rb[:len(b)] = np.frombuffer(b, np.uint8)
        rows.append((ra, len(a), rb, len(b)))

    full = bytes(ALPHABET[np.arange(length) % ALPHABET.size])
    w64 = full[:64]
    add(b"", b"")
    add(b"", b"abc")
    add(b"abc", b"")
    add(b"", full)
    add(full, b"")
    add(b"a", b"a")
    add(b"a", b"b")
    add(b"a", full)
    add(full, b"a")
    add(w64, w64)
    add(w64, w64[::-1])
    add(w64, w64[:63] + b"q")
    add(w64, w64[1:])
    add(full, full)
    add(full, full[::-1])
    add(full, full[:-1])
    add(b"a" * length, b"a" * length)
    add(b"a" * length, b"b" * length)
    add(b"a" * length, b"a" * (length // 2))
    add(b"\xff" * 10, b"\x80" * 10)
    add(b"\xff\x80\xc3", b"\x80\xff\xc3")
    add(b"\x7f\x80", b"\x80\x7f")
    add(b"abc", b"abc", pad_a=0, pad_b=0xFF)     # differ only past the
    add(b"abc", b"abd", pad_a=ord("d"), pad_b=0)  # length
    add(full[:length // 2], full[:length // 2], pad_a=1, pad_b=2)
    ca = np.stack([r[0] for r in rows])
    cb = np.stack([r[2] for r in rows])
    la = np.array([r[1] for r in rows], np.int32)
    lb = np.array([r[3] for r in rows], np.int32)
    return ca, la, cb, lb


def _dp(ca, la, cb, lb):
    """edit_distance_np on each pair (latin-1 maps bytes to characters one
    to one)."""
    return np.array([edit_distance_np(a[:x].tobytes().decode("latin-1"),
                                      b[:y].tobytes().decode("latin-1"))
                     for a, x, b, y in zip(ca, la, cb, lb)], np.int64)


def _torch_dp(ca, la, cb, lb):
    return edit_distance(*(torch.from_numpy(x) for x in (ca, la, cb, lb))
                         ).numpy().astype(np.int64)


def _similarity_f32(d, la, lb):
    """1 - d / max(la, lb, 1) in f32, correctly rounded as on either route."""
    mx = np.maximum(np.maximum(la, lb), 1).astype(np.float32)
    return np.float32(1.0) - d.astype(np.float32) / mx


@pytest.mark.parametrize("length,n,seed", [(64, 2_000, 0), (8, 400, 1),
                                           (100, 400, 2), (200, 300, 3)])
def test_twin_equals_the_dp(length, n, seed):
    ca, la, cb, lb = _random_pairs(np.random.default_rng(seed), n, length)
    got = kernel.bitvector_distance_np(ca, la, cb, lb)
    np.testing.assert_array_equal(got, _torch_dp(ca, la, cb, lb))
    k = n if length <= 64 else 100             # the O(L²) Python DP is slow
    np.testing.assert_array_equal(got[:k], _dp(ca[:k], la[:k], cb[:k],
                                               lb[:k]))


@pytest.mark.parametrize("length", [64, 100, 200])
def test_twin_edge_cases(length):
    ca, la, cb, lb = _edge_pairs(length)
    got = kernel.bitvector_distance_np(ca, la, cb, lb)
    want = _dp(ca, la, cb, lb)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _torch_dp(ca, la, cb, lb))
    # and either way round (the distance is symmetric)
    np.testing.assert_array_equal(
        kernel.bitvector_distance_np(cb, lb, ca, la), want)


def test_twin_similarity_is_the_plain_routes_bit_for_bit():
    ca, la, cb, lb = _random_pairs(np.random.default_rng(5), 1_000, 64)
    d = kernel.bitvector_distance_np(ca, la, cb, lb)
    want = edit_similarity(*(torch.from_numpy(x) for x in (ca, la, cb, lb)))
    assert _similarity_f32(d, la, lb).tobytes() == want.numpy().tobytes()


def test_words_for():
    assert [kernel.words_for(n) for n in (1, 8, 64, 65, 100, 128, 129, 200,
                                          256)] == [1, 1, 1, 2, 2, 2, 4, 4, 4]
    for n in (0, 257, 1024):
        with pytest.raises(ValueError):
            kernel.words_for(n)


def _corpus(rng, n, length=64):
    ca, la, _, _ = _random_pairs(rng, n, length)
    return ca, la


def test_verify_pairs_auto_on_cpu_takes_the_plain_route():
    rng = np.random.default_rng(6)
    codes, lens = _corpus(rng, 300)
    ra = rng.integers(0, 300, 5_000)
    rb = rng.integers(0, 300, 5_000)
    before = dict(stage2_stats)
    ops.reset_launch_counts()
    got = verify_pairs(codes, lens, codes, lens, ra, rb, 0.3, chunk=2_048,
                       device="cpu")
    assert stage2_stats["plain_calls"] == before["plain_calls"] + 1
    assert stage2_stats["plain_pairs"] == before["plain_pairs"] + 5_000
    assert stage2_stats["kernel_calls"] == before["kernel_calls"]
    assert stage2_stats["kernel_pairs"] == before["kernel_pairs"]
    assert ops.launch_counts()["edit_similarity_rows"] == 0
    # the same pairs as the twin's similarities compared on the host
    d = kernel.bitvector_distance_np(codes[ra], lens[ra], codes[rb],
                                     lens[rb])
    sel = np.flatnonzero(_similarity_f32(d, lens[ra], lens[rb]) >= 0.3)
    assert sel.size
    np.testing.assert_array_equal(got[0], ra[sel])
    np.testing.assert_array_equal(got[1], rb[sel])
    # impl="torch" is the same route
    again = verify_pairs(codes, lens, codes, lens, ra, rb, 0.3,
                         device="cpu", impl="torch")
    np.testing.assert_array_equal(again[0], got[0])
    assert stage2_stats["plain_calls"] == before["plain_calls"] + 2


def test_verify_pairs_cuda_on_cpu_raises():
    codes, lens = _corpus(np.random.default_rng(7), 4)
    before = dict(stage2_stats)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        verify_pairs(codes, lens, codes, lens, np.array([0]), np.array([1]),
                     0.5, device="cpu", impl="cuda")
    with pytest.raises(ValueError, match="unknown kernel impl"):
        verify_pairs(codes, lens, codes, lens, np.array([0]), np.array([1]),
                     0.5, device="cpu", impl="xla")
    assert stage2_stats == before


def test_cuda_wrapper_refuses_cpu_tensors():
    codes, lens = _corpus(np.random.default_rng(8), 4)
    c, n = torch.from_numpy(codes), torch.from_numpy(lens)
    rows = torch.tensor([0, 1], dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.edit_similarity_rows(c, n, c, n, rows, rows)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m gpu on the H100")
    return torch.device("cuda")


def _on_card(cuda, ca, la, cb, lb, *, misalign=False):
    """Row-paired inputs as resident matrices plus identity row indices;
    with ``misalign`` the code matrices start one byte past an 8-byte
    boundary (the kernel's byte-load path)."""
    def put(x):
        if not misalign:
            return torch.from_numpy(x).to(cuda)
        buf = torch.zeros(x.size + 1, dtype=torch.uint8, device=cuda)
        out = buf[1:].view(x.shape)
        out.copy_(torch.from_numpy(x))
        return out
    rows = torch.arange(ca.shape[0], dtype=torch.int64, device=cuda)
    return (put(ca), torch.from_numpy(la).to(cuda), put(cb),
            torch.from_numpy(lb).to(cuda), rows, rows)


@pytest.mark.gpu
@pytest.mark.parametrize("length,misalign", [(64, False), (64, True),
                                             (100, False), (200, False),
                                             (200, True)])
def test_kernel_equals_the_plain_route(cuda, length, misalign):
    rng = np.random.default_rng(length + misalign)
    pairs = [_random_pairs(rng, 3_000, length), _edge_pairs(length)]
    ca, la, cb, lb = (np.concatenate(x) for x in zip(*pairs))
    sim, dist = kernel.edit_similarity_rows(
        *_on_card(cuda, ca, la, cb, lb, misalign=misalign), distances=True)
    torch.cuda.synchronize()
    want_d = _torch_dp(ca, la, cb, lb)
    np.testing.assert_array_equal(dist.cpu().numpy(), want_d)
    np.testing.assert_array_equal(dist.cpu().numpy(),
                                  kernel.bitvector_distance_np(ca, la, cb, lb))
    want = edit_similarity(*(torch.from_numpy(x) for x in (ca, la, cb, lb)))
    assert sim.cpu().numpy().tobytes() == want.numpy().tobytes()
    plain_card = edit_similarity(*_on_card(cuda, ca, la, cb, lb)[:4])
    assert sim.cpu().numpy().tobytes() == plain_card.cpu().numpy().tobytes()


@pytest.mark.gpu
def test_verify_pairs_kernel_route_gathers_rows(cuda):
    rng = np.random.default_rng(11)
    codes_a, lens_a = _corpus(rng, 2_000)
    codes_b, lens_b = _corpus(rng, 500)
    ra = rng.integers(0, 2_000, 40_000)
    rb = rng.integers(0, 500, 40_000)
    codes_b[:200] = codes_a[ra[:200] % 2_000]
    lens_b[:200] = lens_a[ra[:200] % 2_000]
    rb[:200] = np.arange(200)
    ca, la = torch.from_numpy(codes_a).to(cuda), torch.from_numpy(lens_a)
    before = dict(stage2_stats)
    ops.reset_launch_counts()
    got = verify_pairs(ca, la, codes_b, lens_b, ra, rb, 0.5)
    assert ops.launch_counts()["edit_similarity_rows"] == 1
    assert stage2_stats["kernel_calls"] == before["kernel_calls"] + 1
    assert stage2_stats["kernel_pairs"] == before["kernel_pairs"] + 40_000
    assert stage2_stats["plain_calls"] == before["plain_calls"]
    want = verify_pairs(ca, la, codes_b, lens_b, ra, rb, 0.5, impl="torch")
    assert stage2_stats["plain_calls"] == before["plain_calls"] + 1
    assert got[0].size >= 200
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # no pairs: no launch
    empty = verify_pairs(ca, la, codes_b, lens_b, ra[:0], rb[:0], 0.5)
    assert empty[0].size == 0 and empty[1].size == 0
    assert ops.launch_counts()["edit_similarity_rows"] == 1
    with pytest.raises(IndexError):
        verify_pairs(ca, la, codes_b, lens_b, np.array([0]), np.array([500]),
                     0.5)


@pytest.mark.gpu
def test_word_model_agrees_with_the_kernel(cuda):
    lib = kernel._lib()
    for n in range(0, 300):
        try:
            want = kernel.words_for(n)
        except ValueError:
            want = -1
        assert lib.edit_distance_words(n) == want, n

"""The n-gram feature kernel (``csrc/ngram_features.cu``) and its route
through ``featurize``.

On the CPU: the kernel's arithmetic, in a NumPy twin (``_kernel_np``:
integer counts, an integer sum of squares, one f32 square root, an f32
divide), held bit for bit to the NumPy route
(``er.encode.ngram_features``) on DS1-law and DS2-law titles and on edge
titles; the wrapper on CPU tensors taking the NumPy route; ``featurize``
keeping that route without a device, on the CPU and under
``kernel_impl="torch"`` (``encode_stats``), and refusing
``kernel_impl="cuda"`` there. On the card (marked ``gpu``): the kernel
against the NumPy route bit for bit, ``run_er`` on the kernel route
against the NumPy route's features and against ``kernel_impl="torch"``,
and an ``ERService`` whose resident features are made on the card."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (one torch thread per test worker)
from repro_torch.er import (ERConfig, ERService, ServiceConfig,  # noqa: E402
                            encode_stats, featurize, make_products,
                            make_publications, pipeline, plan_job, run_er)
from repro_torch.er.encode import encode_titles, ngram_features  # noqa: E402
from repro_torch.kernels import ngram  # noqa: E402

CORPORA = {"ds1": lambda n: make_products(n, seed=3).titles,
           "ds2": lambda n: make_publications(n, seed=4).titles}
DIMS = (128, 256, 100, 130)          # powers of two, and two that are not:
                                     # 100 (16-byte rows), 130 (single floats)

# Empty, 1-2 bytes, exactly 3, a title longer than every max_len, titles of
# one repeated n-gram, and non-ASCII titles that max_len cuts inside a
# character (é is 2 bytes, 語 3, the emoji 4).
EDGE = ["", "a", "ab", "abc", "é", "語", "x" * 300, "abc " * 80,
        "é" * 40, "語" * 70, "😀" * 60, "ab" + "é" * 100, "aaaa",
        "  ", "\x00\x00\x00", "Ünïcödé títlé " * 9]


def _fnv1a(mat):
    h = np.full(mat.shape[0], np.uint64(14695981039346656037), np.uint64)
    for c in range(mat.shape[1]):
        h = (h ^ mat[:, c].astype(np.uint64)) * np.uint64(1099511628211)
    return h


def _kernel_np(codes, lens, dim=256, n=3):
    """The kernel's arithmetic: int64 counts of every valid window's FNV-1a
    bucket (the whole padded row's for len < n), their integer sum of
    squares, then ``count / max(sqrt_f32(ss), 1e-12)`` in f32."""
    lens = np.asarray(lens, np.int64)
    num, length = codes.shape
    counts = np.zeros(num * dim, np.int64)
    if length >= n and num:
        win = np.lib.stride_tricks.sliding_window_view(codes, n, axis=1)
        w = win.shape[1]
        valid = (np.arange(w)[None, :] + n <= lens[:, None]).ravel()
        flat = np.ascontiguousarray(win).reshape(num * w, n)[valid]
        rows = np.repeat(np.arange(num), w)[valid]
        buckets = (_fnv1a(flat) % np.uint64(dim)).astype(np.int64)
        counts += np.bincount(rows * dim + buckets, minlength=num * dim)
    short = np.flatnonzero(lens < n)
    buckets = (_fnv1a(codes[short]) % np.uint64(dim)).astype(np.int64)
    counts[short * dim + buckets] += 1
    counts = counts.reshape(num, dim)
    norm = np.sqrt((counts * counts).sum(axis=1).astype(np.float32))
    denom = np.maximum(norm, np.float32(1e-12))[:, None]
    return counts.astype(np.float32) / denom


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _stats():
    return dict(encode_stats)


def _moved(before):
    return {k: encode_stats[k] - before[k] for k in before}


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("max_len", [64, 200])
@pytest.mark.parametrize("dim", DIMS)
def test_twin_and_cpu_wrapper_equal_the_numpy_route(corpus, max_len, dim):
    codes, lens = encode_titles(CORPORA[corpus](2_000), max_len=max_len)
    want = ngram_features(codes, dim=dim, lengths=lens)
    twin = _kernel_np(codes, lens, dim=dim)
    np.testing.assert_array_equal(_bits(twin), _bits(want))
    before = dict(ngram.LAUNCHES)
    for impl in ("auto", "torch"):
        got = ngram.ngram_features(torch.from_numpy(codes),
                                   torch.from_numpy(lens), dim=dim, impl=impl)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert ngram.LAUNCHES == before


@pytest.mark.parametrize("max_len,n", [(64, 3), (200, 3), (8, 3), (2, 3),
                                       (64, 1), (64, 2), (64, 5)])
def test_twin_edge_titles(max_len, n):
    codes, lens = encode_titles(EDGE, max_len=max_len)
    for dim in (256, 130, 1):
        want = ngram_features(codes, dim=dim, n=n, lengths=lens)
        np.testing.assert_array_equal(
            _bits(_kernel_np(codes, lens, dim=dim, n=n)),
            _bits(want))
        got = ngram.ngram_features(torch.from_numpy(codes),
                                   torch.from_numpy(lens), dim=dim, n=n)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_featurize_keeps_the_numpy_route_off_the_card():
    titles = CORPORA["ds1"](500) + EDGE
    cfg = ERConfig(feature_dim=128, max_len=48)
    codes, lens = encode_titles(titles, max_len=48)
    want = ngram_features(codes, dim=128, lengths=lens)
    launches = dict(ngram.LAUNCHES)
    # without a device (the service's per-batch queries) the host route
    # whatever kernel_impl says, "cuda" included
    for kw, c in (({}, cfg),
                  ({}, ERConfig(feature_dim=128, max_len=48,
                                kernel_impl="cuda")),
                  ({"device": "cpu"}, cfg),
                  ({"device": "cpu"}, ERConfig(feature_dim=128, max_len=48,
                                               kernel_impl="torch"))):
        before = _stats()
        got = featurize(titles, c, **kw)
        if kw:       # with a device: tensors on it
            assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
                       for x in got)
            got = [x.numpy() for x in got]
        else:        # without one: NumPy
            assert all(isinstance(x, np.ndarray) for x in got)
        np.testing.assert_array_equal(got[0], codes)
        np.testing.assert_array_equal(got[1], lens)
        np.testing.assert_array_equal(_bits(got[2]), _bits(want))
        assert _moved(before) == {"kernel_calls": 0, "kernel_rows": 0,
                                  "plain_calls": 1,
                                  "plain_rows": len(titles)}
    assert ngram.LAUNCHES == launches


def test_cuda_route_on_cpu_raises():
    codes, lens = encode_titles(EDGE, max_len=64)
    c, n = torch.from_numpy(codes), torch.from_numpy(lens)
    before = _stats()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ngram.ngram_features(c, n, impl="cuda")
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ngram.ngram_features(c, n, impl="xla")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        featurize(EDGE, ERConfig(kernel_impl="cuda"), device="cpu")
    assert encode_stats == before
    with pytest.raises(ValueError, match="CUDA device"):
        ngram._check(c, n, 256, 3)
    with pytest.raises(ValueError, match="CPU tensors"):
        ngram.ngram_features(c.to("meta"), n.to("meta"))


def test_run_er_and_service_on_cpu_count_the_plain_route():
    titles = CORPORA["ds1"](300)
    cfg = ERConfig(feature_dim=128, max_len=48)
    before = _stats()
    run_er(titles, cfg, device="cpu")
    assert _moved(before)["plain_calls"] == 1
    svc = ERService(titles[:200], ServiceConfig(feature_dim=128, max_len=48),
                    device="cpu")
    assert _moved(before) == {"kernel_calls": 0, "kernel_rows": 0,
                              "plain_calls": 2,
                              "plain_rows": len(titles) + 200}
    svc.match(titles[200:240])
    assert _moved(before)["plain_calls"] == 3
    assert _moved(before)["kernel_calls"] == 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m gpu on the H100")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("max_len", [64, 200])
@pytest.mark.parametrize("dim", DIMS)
def test_kernel_equals_the_numpy_route(cuda, corpus, max_len, dim):
    codes, lens = encode_titles(CORPORA[corpus](20_000), max_len=max_len)
    want = ngram_features(codes, dim=dim, lengths=lens)
    before = dict(ngram.LAUNCHES)
    got = ngram.ngram_features(torch.from_numpy(codes).to(cuda),
                               torch.from_numpy(lens).to(cuda), dim=dim)
    torch.cuda.synchronize()
    assert ngram.LAUNCHES["ngram_features"] == \
        before["ngram_features"] + 1
    assert got.shape == want.shape and got.device.type == "cuda"
    np.testing.assert_array_equal(got.view(torch.int32).cpu().numpy(),
                                  _bits(want))


@pytest.mark.gpu
@pytest.mark.parametrize("max_len,n", [(64, 3), (200, 3), (8, 3), (2, 3),
                                       (64, 1), (64, 2), (64, 5)])
def test_kernel_edge_titles(cuda, max_len, n):
    codes, lens = encode_titles(EDGE, max_len=max_len)
    c, ln = torch.from_numpy(codes).to(cuda), torch.from_numpy(lens).to(cuda)
    for dim in (256, 130, 100, 1, ngram.MAX_DIM):
        want = ngram_features(codes, dim=dim, n=n, lengths=lens)
        got = ngram.ngram_features(c, ln, dim=dim, n=n)
        np.testing.assert_array_equal(got.view(torch.int32).cpu().numpy(),
                                      _bits(want))


@pytest.mark.gpu
def test_kernel_limits_and_refusals(cuda):
    codes, lens = encode_titles(EDGE, max_len=64)
    c, ln = torch.from_numpy(codes).to(cuda), torch.from_numpy(lens).to(cuda)
    before = dict(ngram.LAUNCHES)
    for bad in (dict(dim=0), dict(dim=ngram.MAX_DIM + 1), dict(n=0)):
        with pytest.raises(ValueError):
            ngram.ngram_features(c, ln, **bad)
    with pytest.raises(ValueError, match="int32"):
        ngram.ngram_features(c, ln.long())
    with pytest.raises(ValueError, match="contiguous"):
        ngram.ngram_features(c.t().contiguous().t(), ln)
    with pytest.raises(ValueError, match="one CUDA device"):
        ngram.ngram_features(c, ln.cpu())
    wide = torch.zeros((4, ngram.MAX_WINDOWS + 3), dtype=torch.uint8,
                       device=cuda)
    with pytest.raises(ValueError, match="windows"):
        ngram.ngram_features(wide, ln[:4])
    empty = ngram.ngram_features(c[:0], ln[:0])
    assert empty.shape == (0, 256)
    # the plain route never takes work off the card
    with pytest.raises(ValueError, match="CPU tensors"):
        ngram.ngram_features(c, ln, impl="torch")
    assert ngram.LAUNCHES == before


def _corpus_keyless(n):
    """DS1-law titles, every 37th blank (no blocking key: match_⊥ runs)."""
    titles = list(CORPORA["ds1"](n))
    for i in range(0, n, 37):
        titles[i] = "  "
    return titles


def _recorded_run(monkeypatch, titles, cfg, plain_featurize=False):
    """``run_er`` on the card with every ``verify_pairs`` call's survivor
    rows recorded; ``plain_featurize`` keeps featurize alone on the NumPy
    route (its features uploaded), every later stage on the kernels."""
    calls = []
    inner = pipeline.verify_pairs

    def record(codes_a, lens_a, codes_b, lens_b, rows_a, rows_b, *a, **kw):
        calls.append(torch_parity.pair_set(rows_a, rows_b))
        return inner(codes_a, lens_a, codes_b, lens_b, rows_a, rows_b, *a,
                     **kw)

    real = pipeline.featurize
    with monkeypatch.context() as m:
        m.setattr(pipeline, "verify_pairs", record)
        if plain_featurize:
            m.setattr(pipeline, "featurize",
                      lambda titles, cfg, device=None: real(
                          titles, replace(cfg, kernel_impl="torch"),
                          device=device))
        res = run_er(titles, cfg, device="cuda")
    return res, calls


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["pair_range", "sorted_neighborhood",
                                  "keyless"])
def test_run_er_kernel_route_keeps_every_survivor(cuda, monkeypatch, case):
    keyless = case == "keyless"
    titles = _corpus_keyless(3_000) if keyless else CORPORA["ds1"](3_000)
    strategy = "pair_range" if keyless else case
    cfg = ERConfig(strategy=strategy, feature_dim=128, max_len=48)
    before, launches = _stats(), dict(ngram.LAUNCHES)
    res, calls = _recorded_run(monkeypatch, titles, cfg)
    assert _moved(before) == {"kernel_calls": 1, "kernel_rows": len(titles),
                              "plain_calls": 0, "plain_rows": 0}
    assert ngram.LAUNCHES["ngram_features"] == \
        launches["ngram_features"] + 1
    assert len(calls) == (2 if keyless else 1)
    assert sum(map(len, calls)) > 0 and res.matches
    # the same kernels downstream, features from the NumPy route: equal
    plain, plain_calls = _recorded_run(monkeypatch, titles, cfg,
                                       plain_featurize=True)
    assert calls == plain_calls
    assert res.matches == plain.matches
    # everything on the plain route: equal but for near-threshold cells
    torch_cfg = ERConfig(strategy=strategy, feature_dim=128, max_len=48,
                         kernel_impl="torch")
    before = _stats()
    ref, ref_calls = _recorded_run(monkeypatch, titles, torch_cfg)
    assert _moved(before)["plain_calls"] == 1
    assert res.matches == ref.matches
    codes, lens = encode_titles(titles, max_len=48)
    feats = ngram_features(codes, dim=128, lengths=lens)
    jp = plan_job(titles, cfg)
    sides = [(feats[jp.to_global], feats[jp.to_global])]
    if keyless:
        sides.append((feats, feats[jp.null_idx]))
    for got, want, (fa, fb) in zip(calls, ref_calls, sides):
        torch_parity.near_threshold_flips(got, want, fa, fb,
                                          cfg.threshold - cfg.filter_margin)


@pytest.mark.gpu
def test_service_resident_features_made_on_the_card(cuda):
    titles = _corpus_keyless(2_000)
    cfg = ServiceConfig(feature_dim=128, max_len=48)
    before = _stats()
    svc = ERService(titles[:1_600], cfg, device="cuda")
    assert _moved(before) == {"kernel_calls": 1, "kernel_rows": 1_600,
                              "plain_calls": 0, "plain_rows": 0}
    codes, lens = encode_titles(titles[:1_600], max_len=48)
    feats = ngram_features(codes, dim=128, lengths=lens)
    g, z = svc._to_global, svc._null_idx
    assert z.size > 0
    for got, want in ((svc._feats_keyed, feats[g]), (svc._feats_all, feats),
                      (svc._feats_null, feats[z])):
        assert got.device.type == "cuda" and got.is_contiguous()
        np.testing.assert_array_equal(got.view(torch.int32).cpu().numpy(),
                                      _bits(want))
    for got, want in ((svc._k_codes, codes[g]), (svc._k_lens, lens[g]),
                      (svc._codes, codes), (svc._lens, lens),
                      (svc._n_codes, codes[z]), (svc._n_lens, lens[z])):
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    # per-batch queries stay on the NumPy route
    before = _stats()
    got = svc.match(titles[1_600:1_700])
    assert _moved(before) == {"kernel_calls": 0, "kernel_rows": 0,
                              "plain_calls": 1, "plain_rows": 100}
    cpu = ERService(titles[:1_600], cfg, device="cpu")
    assert set(got) == set(cpu.match(titles[1_600:1_700]))


@pytest.mark.gpu
def test_mesh_keeps_the_host_route_under_cuda_impl(cuda):
    """A mesh on the card featurizes on the host even under
    ``kernel_impl="cuda"``, for ``run_er`` and the service's ingest, and
    gives what the kernel route gives without a mesh."""
    from repro_torch.sharding import make_er_mesh

    titles = _corpus_keyless(2_000)
    mesh = make_er_mesh(2, devices=["cuda:0"] * 2)
    cfg = ERConfig(feature_dim=128, max_len=48, kernel_impl="cuda")
    before = _stats()
    res = run_er(titles, cfg, mesh=mesh, device="cuda")
    assert _moved(before) == {"kernel_calls": 0, "kernel_rows": 0,
                              "plain_calls": 1, "plain_rows": len(titles)}
    assert res.matches == run_er(titles, cfg, device="cuda").matches
    scfg = ServiceConfig(feature_dim=128, max_len=48, kernel_impl="cuda")
    before = _stats()
    svc = ERService(titles[:1_600], scfg, mesh=mesh, device="cuda")
    assert _moved(before)["plain_calls"] == 1
    assert _moved(before)["kernel_calls"] == 0
    one = ERService(titles[:1_600], scfg, device="cuda")
    queries = titles[1_600:1_700]
    assert set(svc.match(queries)) == set(one.match(queries))

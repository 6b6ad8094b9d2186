"""Shared inputs of the port's parity tests: dyadic and unit-row features,
random catalogs that exercise every predicate, the skewed corpus of
tests/test_executor_parity.py with and without key-less titles, and the
serving round (prefill, one decode step, greedy generate) of the LM
parity tests, run by the reference and by the port."""
import numpy as np
import torch

from repro_torch.er import exponential_block_ids, make_products
from repro_torch.er.compiler.ir import NO_LB, NO_UB
from repro_torch.kernels.pair_sim import NCOLS

# The test files run side by side in several worker processes; one
# intra-op thread each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

SHAPES = [(64, 64, 32), (200, 130, 64), (128, 128, 256), (257, 31, 128)]
DTYPES = ["float32", "bfloat16"]


def dyadic(rng, n, d):
    return (rng.integers(-4, 5, (n, d)) / 8.0).astype(np.float32)


def unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def catalog(rng, m, n, bm, bn, t=24, pad=3, only=None):
    """Random entries exercising every predicate (window, tri, lb/ub
    corner cuts, band) over the strips of an (m, n) problem, plus ``pad``
    all-zero rows. ``only`` keeps a single predicate active."""
    ti = rng.integers(0, -(-m // bm), t)
    tj = rng.integers(0, -(-n // bn), t)
    cat = np.zeros((t, NCOLS), np.int64)
    cat[:, 0], cat[:, 1] = ti, tj
    cat[:, 2] = ti * bm + rng.integers(0, bm // 2, t)
    cat[:, 3] = np.minimum(cat[:, 2] + rng.integers(1, bm + 1, t), m)
    cat[:, 4] = tj * bn + rng.integers(0, bn // 2, t)
    cat[:, 5] = np.minimum(cat[:, 4] + rng.integers(1, bn + 1, t), n)
    cat[:, 6] = rng.integers(0, 2, t)
    cut = rng.random(t) < 0.5
    cat[:, 7] = np.where(cut, cat[:, 2] + rng.integers(0, bm, t), NO_LB)
    cat[:, 8] = np.where(cut, cat[:, 4] + rng.integers(0, bn, t), NO_LB)
    cut = rng.random(t) < 0.5
    cat[:, 9] = np.where(cut, cat[:, 2] + rng.integers(0, bm, t), NO_UB)
    cat[:, 10] = np.where(cut, cat[:, 4] + rng.integers(0, bn, t), NO_UB)
    cat[:, 11] = np.where(rng.random(t) < 0.5, rng.integers(1, 2 * bn, t), 0)
    if only is not None:
        keep = {"window": (), "tri": (6,), "lb": (7, 8), "ub": (9, 10),
                "band": (11,)}[only]
        for c in (6, 7, 8, 9, 10, 11):
            if c not in keep:
                cat[:, c] = {7: NO_LB, 8: NO_LB, 9: NO_UB, 10: NO_UB}.get(c, 0)
    cat = np.concatenate([cat, np.zeros((pad, NCOLS), np.int64)])
    return cat.astype(np.int32)


def assert_near_threshold_only(got, want, a, b, cat, bm, bn, thr):
    """Masks agree except on cells whose f64 score is within 1e-6 of thr."""
    diff = np.argwhere(got != want)
    for t, i, j in diff:
        s = np.dot(a[cat[t, 0] * bm + i].astype(np.float64),
                   b[cat[t, 1] * bn + j].astype(np.float64))
        assert abs(s - float(np.float32(thr))) <= 1e-6, (t, i, j, s)


def skewed_corpus():
    """tests/test_executor_parity.py's corpus: 1,200 titles blocked by the
    Fig. 9 s=1.0 skew. Returns (titles, block_ids)."""
    ds = make_products(1200, seed=11)
    bid = exponential_block_ids(ds.n, b=30, s=1.0,
                                rng=np.random.default_rng(11))
    return list(ds.titles), bid


def keyless(titles, bid):
    """Every 41st entity loses its blocking key (block id −1, title
    blank), so the match_⊥ cross job runs."""
    titles, bid = list(titles), bid.copy()
    for i in range(0, len(titles), 41):
        titles[i], bid[i] = "  ", -1
    return titles, bid


# ---------------------------------------------------------------------------
# LM serving parity (tests/test_torch_models*.py)
# ---------------------------------------------------------------------------

LM_B, LM_S, LM_NEW = 2, 16, 5


def lm_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (LM_B, LM_S))
             .astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (LM_B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (LM_B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return batch


def lm_reference(jcfg, seed):
    """The reference's random-init params (as numpy), its prefill logits,
    the greedy next token, the decode-step logits and ``generate``'s
    greedy tokens on one batch."""
    import jax
    import jax.numpy as jnp
    from repro.models import get_model
    from repro.serve import generate

    mod = get_model(jcfg)
    params = mod.init(jcfg, jax.random.key(seed))
    batch = lm_batch(jcfg, seed)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    prefix = jcfg.n_patches if jcfg.family == "vlm" else 0
    cache = mod.init_cache(jcfg, LM_B, LM_S + prefix + LM_NEW)
    last, cache = mod.prefill(params, jbatch, jcfg, cache)
    nxt = jnp.argmax(last[:, -1:], axis=-1)
    step, _ = mod.decode_step(params, nxt, cache, jcfg)
    toks = generate(params, jcfg, jbatch, max_new_tokens=LM_NEW)
    return (jax.tree.map(np.asarray, params), batch, np.asarray(last),
            np.asarray(nxt), np.asarray(step), np.asarray(toks))


def lm_port(cfg, tree, batch, nxt):
    """The same round by the port on the CPU, on ``tree`` converted by
    ``model_params_from``: (prefill logits, decode logits, tokens)."""
    from repro_torch.convert import model_params_from
    from repro_torch.models import get_model
    from repro_torch.serve import generate, make_decode_step, make_prefill

    model = model_params_from(tree, cfg, device="cpu")
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    cache = get_model(cfg).init_cache(cfg, LM_B, LM_S + prefix + LM_NEW,
                                      device="cpu")
    last, cache = make_prefill(cfg, device="cpu")(model, batch, cache)
    step, cache = make_decode_step(cfg, device="cpu")(
        model, torch.from_numpy(np.array(nxt)), cache)
    assert cache["pos"] == LM_S + prefix + 1
    toks = generate(model, cfg, batch, max_new_tokens=LM_NEW, device="cpu")
    return last.numpy(), step.numpy(), toks.numpy()


# ---------------------------------------------------------------------------
# Mesh parity (tests/test_torch_mesh*.py, tests/test_torch_distributed.py)
# ---------------------------------------------------------------------------

JAX_MESH_DEVICES = 16


def jax_mesh_reference(script: str, out_path) -> dict:
    """Run ``script`` — reference code that builds its meshes from
    ``JAX_MESH_DEVICES`` simulated host devices and ``np.savez``-es its
    results to the path in ``sys.argv[1]`` — in a subprocess (the device
    count must be set before JAX starts; the test process has one device)
    and return the saved arrays."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                        f"{JAX_MESH_DEVICES}")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(root, "src"), os.path.join(root, "tests")])
    proc = subprocess.run([sys.executable, "-c", script, str(out_path)],
                          env=env, capture_output=True, text=True,
                          timeout=600, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(out_path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def cpu_mesh(n_data: int, n_model: int = 1):
    """The port's mesh of ``n_data × n_model`` logical CPU shards."""
    from repro_torch.sharding import make_er_mesh
    return make_er_mesh(n_data, n_model, devices=["cpu"] * (n_data * n_model))


def pair_set(rows_a, rows_b) -> set:
    return set(zip(np.asarray(rows_a).tolist(), np.asarray(rows_b).tolist()))


def near_threshold_flips(got: set, want: set, feats_a, feats_b, thr,
                         near: float = 1e-6) -> list:
    """The pairs in one set only; raises unless each one's f64 score lies
    within ``near`` of the f32 threshold."""
    flips = sorted(got ^ want)
    t = float(np.float32(thr))
    for a, b in flips:
        s = float(np.dot(np.asarray(feats_a[a], np.float64),
                         np.asarray(feats_b[b], np.float64)))
        assert abs(s - t) <= near, (a, b, s, t)
    return flips


LEGACY_N_DEV = 8


def legacy_mesh_inputs(mod_core, mod_er):
    """tests/test_distributed_er.py's blocked inputs, built with one
    package's numpy code: (feats, codes, lens, plan, rows) in the
    blocked layout, rows being the Basic plan's per-reducer pairs."""
    ds = mod_er.make_products(1024, seed=5)
    bid, _ = mod_er.prefix_block_ids(ds.titles, ds.prefix_len)
    n = ds.n - ds.n % LEGACY_N_DEV
    titles, bid = list(ds.titles[:n]), bid[:n]
    num_blocks = int(bid.max()) + 1
    part = np.repeat(np.arange(LEGACY_N_DEV), n // LEGACY_N_DEV)
    bdm = mod_core.compute_bdm(bid, part, num_blocks, LEGACY_N_DEV)
    codes, lens = mod_er.encode_titles(titles, 48)
    feats = mod_er.ngram_features(codes, dim=128, lengths=lens)
    plan = mod_core.plan_pair_range(bdm, LEGACY_N_DEV)
    perm, estart = mod_core.blocked_layout(
        bid, mod_core.entity_indices(bid, part, bdm), plan.block_sizes)
    bplan = mod_core.plan_basic(bdm, LEGACY_N_DEV)
    rows = [(np.zeros(0, np.int64), np.zeros(0, np.int64))
            for _ in range(LEGACY_N_DEV)]
    for k_blk in range(num_blocks):
        if plan.block_sizes[k_blk] < 2:
            continue
        x, y = np.triu_indices(int(plan.block_sizes[k_blk]), k=1)
        r = int(bplan.block_reducer[k_blk])
        rows[r] = (np.concatenate([rows[r][0], estart[k_blk] + x]),
                   np.concatenate([rows[r][1], estart[k_blk] + y]))
    return feats[perm], codes[perm], lens[perm], plan, rows


def lm_consistency(cfg, model, seed=1, tol=dict(atol=2e-3, rtol=1e-2)):
    """tests/test_arch_smoke.py::test_prefill_decode_consistency on the
    port (CPU): prefill's last logits equal ``forward``'s last position,
    and one decode step equals ``forward`` over the prompt + that token."""
    from repro_torch.models import get_model

    mod = get_model(cfg)
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(cfg, seed).items()}
    full = mod.forward(model, batch, cfg, device="cpu")
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    cache = mod.init_cache(cfg, LM_B, LM_S + prefix + 4, device="cpu")
    last, cache = mod.prefill(model, batch, cfg, cache, device="cpu")
    assert bool(torch.isfinite(last).all())
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(),
                               **tol)
    nxt = torch.argmax(last[:, -1:], dim=-1)
    step, cache = mod.decode_step(model, nxt, cache, cfg, device="cpu")
    full2 = mod.forward(model, dict(batch, tokens=torch.cat(
        [batch["tokens"], nxt], dim=1)), cfg, device="cpu")
    np.testing.assert_allclose(step[:, 0].numpy(), full2[:, -1].numpy(),
                               **tol)


LONG_S = 512   # > 256 and a multiple of it: the chunked recurrence


def lm_long_prompt(arch, seed=2):
    """A LONG_S-token prompt through the reference and the port at
    ``reduced()`` size (batch 1): the reference's prefill logits and the
    gradient of its ``loss_fn`` (the chunked, rematted scans), against the
    port's prefill and the gradient of its ``loss_fn`` under autograd
    (chunks of 256 under ``remat``). Returns (max |Δ logits|, {name:
    (port grad, reference grad)})."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import get_model as jget_model
    from repro.train.train_step import loss_fn as jloss_fn
    from repro_torch import configs
    from repro_torch.convert import model_params_from
    from repro_torch.models import get_model
    from repro_torch.train.train_step import loss_fn

    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    jmod = jget_model(jcfg)
    params = jmod.init(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab, (1, LONG_S)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (1, LONG_S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": labels}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, _ = jmod.prefill(params, jbatch, jcfg,
                           jmod.init_cache(jcfg, 1, LONG_S))
    jgrads = jax.grad(lambda p: jloss_fn(p, jbatch, jcfg)[0])(params)

    cfg = configs.reduced(configs.get_config(arch))
    mod = get_model(cfg)
    tree = jax.tree.map(np.asarray, params)
    model = model_params_from(tree, cfg, device="cpu")
    got, _ = mod.prefill(model, batch, cfg,
                         mod.init_cache(cfg, 1, LONG_S, device="cpu"),
                         device="cpu")
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss, _ = loss_fn(model, batch, cfg)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    ref = dict(model_params_from(jax.tree.map(np.asarray, jgrads), cfg,
                                 device="cpu").named_parameters())
    diff = float(np.abs(got.numpy() - np.asarray(want)).max())
    return diff, {n: (g.numpy(), ref[n].detach().numpy())
                  for n, g in grads.items()}


# ---------------------------------------------------------------------------
# Benchmark legs (tests/test_torch_bench_*.py)
# ---------------------------------------------------------------------------

def bench_legs(name: str, monkeypatch, out_dir):
    """The JAX leg ``benchmarks/<name>.py`` and the port's
    ``benchmarks/torch_<name>.py``, with ``benchmarks.common.OUT_DIR``
    pointed at ``out_dir`` so that neither writes into the tree."""
    import importlib
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    common = importlib.import_module("benchmarks.common")
    monkeypatch.setattr(common, "OUT_DIR", str(out_dir))
    return (importlib.import_module(f"benchmarks.{name}"),
            importlib.import_module(f"benchmarks.torch_{name}"))


def load_example(name: str):
    """``examples/torch_<name>.py`` as a module (importing it runs nothing:
    each example runs under its ``__main__`` guard)."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", os.path.join(root, "examples", f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

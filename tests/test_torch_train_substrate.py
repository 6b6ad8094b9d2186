"""The port's training substrate against the JAX package on the CPU, as
tests/test_train_substrate.py holds the reference: AdamW (f32 and bf16
moments) on a random tree equal to ``repro.train.optimizer.adamw_update``
within 1e-6, global norm, clipping and the cosine schedule equal to the
reference's, the synthetic LM stream and the LPT packer giving the
reference's arrays exactly, checkpoints (a bit-exact round trip with bf16
leaves, the async writer, an elastic restore into a fresh model), the
loss-decreases smoke with the reference's numbers through
``make_train_step``, and the train launcher's bit-exact resume."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch_parity as tp  # noqa: E402,F401  (one torch thread per worker)
from repro import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import (lpt_pack, pack_documents,  # noqa: E402
                              synthetic_lm_batches)
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train import adamw_init, make_train_step  # noqa: E402
from repro_torch.train.checkpoint import (async_save, latest_step,  # noqa: E402
                                          restore, save)
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,  # noqa: E402
                                         cosine_lr, global_norm)

SHAPES = {"w": (16, 8), "b": (8,), "emb": (32, 4), "s": ()}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.standard_normal(s) * scale, np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1.0, 100.0])
def test_adamw_update_equals_reference(moment_dtype, clip_norm):
    """Four updates from the same params and grads (and a cosine lr read
    at the step before the update, as the train step does): params,
    moments and grad norms within 1e-6 of the reference's."""
    kw = dict(lr=1e-2, moment_dtype=moment_dtype, clip_norm=clip_norm)
    jcfg, cfg = jopt.AdamWConfig(**kw), AdamWConfig(**kw)
    params = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, state = jopt.adamw_init(jp, jcfg), adamw_init(tparams, cfg)
    assert state["m"]["w"].dtype == getattr(torch, moment_dtype)
    for i in range(4):
        grads = _tree(10 + i, scale=3.0)
        jlr = jopt.cosine_lr(jstate["step"], peak=1e-2, warmup=2, total=6)
        lr = cosine_lr(state["step"], peak=1e-2, warmup=2, total=6)
        np.testing.assert_allclose(float(lr), float(jlr), rtol=1e-6)
        jp, jstate, jstats = jopt.adamw_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp, jcfg,
            lr=jlr)
        tparams, state, stats = adamw_update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, state,
            tparams, cfg, lr=lr)
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        for k in SHAPES:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jp[k]), atol=1e-6)
            for mk in ("m", "v"):
                np.testing.assert_allclose(
                    state[mk][k].float().numpy(),
                    np.asarray(jstate[mk][k], np.float32), atol=1e-6,
                    rtol=1e-2 if moment_dtype == "bfloat16" else 1e-6)


def test_adamw_decreases_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = adamw_init(params, cfg)
    for _ in range(200):
        params, opt, _ = adamw_update({"w": 2 * params["w"]}, opt, params,
                                      cfg)
    assert float(params["w"].abs().max()) < 0.2


def test_global_norm_and_clipping_equal_reference():
    g = _tree(3, scale=100.0)
    np.testing.assert_allclose(
        float(global_norm({k: torch.from_numpy(v) for k, v in g.items()})),
        float(jopt.global_norm({k: jnp.asarray(v) for k, v in g.items()})),
        rtol=1e-6)
    big = {"a": torch.full((10,), 100.0)}
    assert float(global_norm(big)) == pytest.approx(np.sqrt(10) * 100)
    cfg = AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    params = {"a": torch.zeros(10)}
    p2, _, stats = adamw_update(big, adamw_init(params, cfg), params, cfg)
    assert float(stats["grad_norm"]) > 1.0
    assert bool(torch.isfinite(p2["a"]).all())


def test_cosine_lr_equals_reference():
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got = float(cosine_lr(step, peak=3e-3, warmup=10, total=100))
        want = float(jopt.cosine_lr(jnp.asarray(step, jnp.int32), peak=3e-3,
                                    warmup=10, total=100))
        assert got == pytest.approx(want, rel=1e-6), step
    assert float(cosine_lr(0, peak=1.0, warmup=10, total=100)) < 0.2
    assert float(cosine_lr(10, peak=1.0, warmup=10, total=100)) == \
        pytest.approx(1.0, abs=0.05)


@pytest.mark.parametrize("vocab,batch,seq,seed", [(128, 8, 32, 0),
                                                  (512, 4, 64, 3),
                                                  (1000, 2, 128, 7)])
def test_synthetic_batches_equal_reference(vocab, batch, seq, seed):
    got = synthetic_lm_batches(vocab, batch, seq, seed)
    want = jdata.synthetic_lm_batches(vocab, batch, seq, seed)
    for _ in range(3):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w) == ["labels", "tokens"]
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_packing_equals_reference():
    rng = np.random.default_rng(0)
    lengths = (rng.zipf(1.6, 200) * 10).clip(1, 5000)
    got, stats = lpt_pack(lengths, 8)
    want, jstats = jdata.lpt_pack(lengths, 8)
    np.testing.assert_array_equal(got, want)
    assert stats == jstats and stats["imbalance"] < 1.4
    docs = [rng.integers(2, 50, int(n)).astype(np.int32)
            for n in rng.integers(1, 40, 30)]
    for rows, row_len in ((4, 64), (3, 16)):
        t, m = pack_documents(docs, rows, row_len)
        jt, jm = jdata.pack_documents(docs, rows, row_len)
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(m, jm)
    tokens, mask = pack_documents(
        [np.arange(2, 12, dtype=np.int32), np.arange(5, dtype=np.int32)],
        n_rows=2, row_len=16, pad_id=0, eos_id=1)
    assert tokens.shape == (2, 16) and mask.sum() == (10 + 1) + (5 + 1)


def test_checkpoint_roundtrip_bit_exact(tmp_path):
    """bf16 leaves (stored as their bits), f32, int32 and int64 leaves,
    names with dots, a numpy leaf and a 0-dim scalar come back equal bit
    for bit."""
    g = torch.Generator().manual_seed(0)
    bf = torch.randn((5, 7), generator=g).to(torch.bfloat16)
    bf[0, :4] = torch.tensor([float("inf"), -0.0, 1e-40, float("nan")])
    tree = {"params": {"layers.0.wq": bf,
                       "embed": torch.randn((3, 4), generator=g)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "ids": torch.arange(6)},
            "host": np.arange(12, dtype=np.float32).reshape(3, 4),
            "scale": np.float32(2.5)}
    save(str(tmp_path), tree, step=7, num_shards=3)
    assert latest_step(str(tmp_path)) == 7
    got, step = restore(str(tmp_path), device="cpu")
    assert step == 7
    a = got["params"]["layers.0.wq"]
    assert a.dtype == torch.bfloat16
    assert torch.equal(a.view(torch.int16), bf.view(torch.int16))
    assert torch.equal(got["params"]["embed"], tree["params"]["embed"])
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 7
    assert torch.equal(got["opt"]["ids"], torch.arange(6))
    np.testing.assert_array_equal(got["host"].numpy(), tree["host"])
    assert float(got["scale"]) == 2.5


def test_checkpoint_async_and_atomic(tmp_path):
    saver = async_save(str(tmp_path), num_shards=2)
    w = torch.ones((8, 8))
    saver({"w": w}, 1)
    w.add_(1)                 # an in-place update after the call
    saver({"w": w}, 2)        # waits for the first, then writes
    saver.wait()
    assert latest_step(str(tmp_path)) == 2
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    first, _ = restore(str(tmp_path), step=1, device="cpu")
    assert torch.equal(first["w"], torch.ones((8, 8)))  # the host copy
    bad = async_save(str(tmp_path / "file"))
    (tmp_path / "file").write_text("not a directory")
    bad({"w": w}, 3)
    with pytest.raises(OSError):
        bad.wait()


def test_checkpoint_elastic_restore(tmp_path):
    """A bf16 model saved from one device restores onto another (here:
    saved from a model, restored as a new one) and serves the same
    logits; restore without a card needs device='cpu'."""
    cfg = configs.reduced(configs.get_config("smollm-360m")).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    mod = get_model(cfg)
    model = mod.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    save(str(tmp_path), launch.state_tree(model, adamw_init(model)), step=1)
    got, _ = restore(str(tmp_path), device="cpu")
    fresh = mod.empty(cfg, device="cpu")
    opt = adamw_init(fresh)
    launch.load_state(fresh, opt, got)
    batch = {"tokens": np.zeros((2, 8), np.int32)}
    assert torch.equal(mod.forward(fresh, batch, cfg, device="cpu"),
                       mod.forward(model, batch, cfg, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            restore(str(tmp_path))


def test_loss_decreases_smoke():
    """tests/test_train_substrate.py's numbers: 40 steps at lr 3e-3 on
    the synthetic stream, the loss falls by more than 0.5."""
    cfg = configs.reduced(configs.get_config("smollm-360m"), vocab=128)
    mod = get_model(cfg)
    model = mod.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt_cfg = AdamWConfig(lr=3e-3)
    step = make_train_step(cfg, opt_cfg, total_steps=60)
    opt = adamw_init(model, opt_cfg)
    losses = []
    for _, batch in zip(range(40), synthetic_lm_batches(cfg.vocab, 8, 32)):
        model, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::8]
    assert not any(p.requires_grad for p in model.parameters())


def test_train_launcher_resumes_bit_exact(tmp_path, capsys):
    """``launch.train``: 6 steps with checkpoints every 3, then a second
    run to 8 resumes from step 6 with the first run's params and moments
    bit for bit; main returns 0 and logs the reference's line."""
    argv = ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--log-every", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    first = launch.train(launch.parse_args(argv + ["--steps", "6"]))
    assert first["start"] == 0 and len(first["losses"]) == 6
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000006"]
    state, step = restore(str(tmp_path), device="cpu")
    assert step == 6
    for name, p in first["model"].named_parameters():
        assert torch.equal(state["params"][name], p), name
    for name, m in first["opt_state"]["m"].items():
        assert torch.equal(state["opt"]["m"][name], m), name
    capsys.readouterr()
    assert launch.main(argv + ["--steps", "8"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 6" in out
    assert "step     7  loss" in out and "tok/s" in out and "gnorm" in out
    assert latest_step(str(tmp_path)) == 8

"""The port's train step against the JAX package on the CPU, for all ten
archs at ``reduced()`` size, f32 (tests/test_arch_smoke.py's forward and
train step, at matched params): the port's forward logits within atol
1e-4 of the reference's, and three ``make_train_step`` steps from the
same converted params and ``adamw_init`` state giving the reference's
loss, lr, xent, aux and grad_norm within rtol 1e-4 (aux within atol 1e-6:
0 for every family but moe) and the same params within atol 1e-5. Then a
fourth step from the reference's optimizer state converted by
``convert.opt_state_from``. Also: both kernel routes and
``make_train_step`` refuse autograd, and the plain routes differentiate.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_parity as tp  # noqa: E402  (one torch thread per worker)
from repro import configs as jconfigs  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.train import adamw_init as jadamw_init  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train.optimizer import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import model_params_from, opt_state_from  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train import adamw_init, make_train_step  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402

LR = 1e-3
STEPS = 3
METRICS = ("loss", "lr", "xent", "grad_norm")


def _batch(cfg):
    batch = tp.lm_batch(cfg, 0)
    labels = np.random.default_rng(99).integers(
        0, cfg.vocab, batch["tokens"].shape).astype(np.int32)
    labels[0, :3] = -100                     # ignored positions
    batch["labels"] = labels
    return batch


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(jconfigs.ARCHS))
def reference(request):
    """The reference's random-init params, forward logits, and STEPS + 1
    jitted train steps (metrics and params after STEPS, the optimizer
    state after STEPS, params after the last)."""
    arch = request.param
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    params = jget_model(jcfg).init(jcfg, jax.random.key(0))
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits = np.asarray(jget_model(jcfg).forward(params, jb, jcfg))
    step = jax.jit(jmake_train_step(jcfg, JAdamWConfig(lr=LR)))
    opt = jadamw_init(params, JAdamWConfig(lr=LR))
    tree, metrics, p = _np(params), [], params
    for _ in range(STEPS):
        p, opt, m = step(p, opt, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    after, opt_after = _np(p), _np(opt)
    p, _, m = step(p, opt, jb)
    metrics.append({k: float(v) for k, v in m.items()})
    return dict(arch=arch, tree=tree, batch=batch, logits=logits,
                metrics=metrics, after=after, opt_after=opt_after,
                last=_np(p))


def _port(arch, tree):
    cfg = configs.reduced(configs.get_config(arch))
    return cfg, model_params_from(tree, cfg, device="cpu")


def _assert_params(model, tree, cfg):
    want = dict(model_params_from(tree, cfg, device="cpu")
                .named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)


def _assert_metrics(got, want):
    for k in METRICS:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(got["aux"]), want["aux"], rtol=1e-4,
                               atol=1e-6, err_msg="aux")


def test_forward_logits_equal_reference(reference):
    cfg, model = _port(reference["arch"], reference["tree"])
    got = get_model(cfg).forward(model, reference["batch"], cfg,
                                 device="cpu")
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), reference["logits"], atol=1e-4)


def test_train_steps_equal_reference(reference):
    cfg, model = _port(reference["arch"], reference["tree"])
    step = make_train_step(cfg, AdamWConfig(lr=LR))
    opt = adamw_init(model, AdamWConfig(lr=LR))
    for i in range(STEPS):
        model, opt, metrics = step(model, opt, reference["batch"])
        _assert_metrics(metrics, reference["metrics"][i])
    assert int(opt["step"]) == STEPS
    assert not any(p.requires_grad for p in model.parameters())
    _assert_params(model, reference["after"], cfg)
    if cfg.family == "moe":     # the router aux loss carries its gradient
        assert float(reference["metrics"][0]["aux"]) > 0


def test_step_continues_from_reference_opt_state(reference):
    cfg, model = _port(reference["arch"], reference["after"])
    opt = opt_state_from(reference["opt_after"], model)
    assert int(opt["step"]) == STEPS
    step = make_train_step(cfg, AdamWConfig(lr=LR))
    model, opt, metrics = step(model, opt, reference["batch"])
    _assert_metrics(metrics, reference["metrics"][STEPS])
    _assert_params(model, reference["last"], cfg)


@pytest.mark.parametrize("arch,over", [
    ("smollm-360m", dict(attn_impl="kernel")),
    ("zamba2-2.7b", dict(attn_impl="kernel")),
    ("granite-moe-1b-a400m", dict(moe_dispatch="grouped")),
    ("granite-moe-1b-a400m", dict(attn_impl="kernel",
                                  moe_dispatch="grouped"))])
def test_make_train_step_refuses_kernel_routes(arch, over):
    cfg = configs.reduced(configs.get_config(arch)).replace(**over)
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(cfg)


def _qkv(requires_grad):
    g = torch.Generator().manual_seed(0)
    return [torch.randn((1, n, 128, 16), generator=g).requires_grad_(
        requires_grad) for n in (4, 2, 2)]


def test_kernel_routes_refuse_autograd():
    """The CUDA route of both ops raises under autograd, before it would
    launch (on CPU tensors too); under no_grad it only asks for CUDA
    tensors, as before; the plain routes differentiate."""
    q, k, v = _qkv(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.attention(q, k, v, impl="cuda")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        ops.attention(q, k, v, impl="cuda")
    with torch.no_grad():   # auto on CPU tensors is the plain version
        ops.attention(q, k, v, impl="auto")
    x = torch.randn((16, 8), requires_grad=True)
    w = torch.randn((2, 8, 4), requires_grad=True)
    te = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.grouped_matmul(x, te, w, block_t=8, impl="cuda")
    out = ops.attention(q, k, v, impl="auto")
    y = ops.grouped_matmul(x, te, w, block_t=8, impl="auto")
    (out.square().sum() + y.square().sum()).backward()
    for t in (q, k, v, x, w):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.abs().max()) > 0

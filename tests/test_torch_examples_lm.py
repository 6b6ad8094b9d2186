"""The port's LM examples (``examples/torch_serve_lm.py``,
``torch_train_lm.py``) on the CPU at a few tokens and two steps: the
output's shape and token range, the serving header the JAX example
prints, the 100M config in the port's ``ARCHS`` (the JAX example's
parameter count), a finite loss, a resume from the example's own
checkpoint directory, never the JAX example's. Greedy tokens of random
weights are not compared across packages."""
import contextlib
import io
import math
import os
import runpy
import sys
import tempfile
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from torch_parity import load_example  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def test_serve_lm_shape_and_header(monkeypatch):
    argv = ["--batch", "2", "--prompt-len", "8", "--tokens", "4"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = load_example("serve_lm").main(argv + ["--device", "cpu"])
    assert got["shape"] == [2, 4]
    assert 0 <= got["min_token"] <= got["max_token"] < got["vocab"] == 512
    monkeypatch.setattr(sys, "argv", ["serve_lm.py"] + argv)
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        runpy.run_path(str(EXAMPLES / "serve_lm.py"), run_name="__main__")
    assert out.getvalue().splitlines()[0] == want.getvalue().splitlines()[0]


@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_serve_lm_is_repeatable(temperature):
    """Seeded weights and an explicit generator: two runs agree."""
    mod = load_example("serve_lm")
    argv = ["--batch", "2", "--prompt-len", "8", "--tokens", "6",
            "--temperature", temperature, "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        a, b = mod.main(argv), mod.main(argv)
    assert a == b


def test_train_lm_config_is_the_jax_examples():
    from repro import configs as jconfigs

    cfg = load_example("train_lm").config_100m()
    want = jconfigs.get_config("smollm-360m").replace(
        n_layers=12, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=1536, vocab=8192, param_dtype="float32",
        compute_dtype="float32", remat=False, act_shard="none")
    assert cfg.param_count() == want.param_count()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "param_dtype", "compute_dtype", "remat"):
        assert getattr(cfg, f) == getattr(want, f), f


def test_train_lm_checkpoints_apart_from_the_jax_example():
    mod = load_example("train_lm")
    assert mod.CKPT_DIR == os.path.join(tempfile.gettempdir(),
                                        "repro_torch_ckpt_100m")
    assert "repro_ckpt_100m" not in mod.CKPT_DIR


def test_train_lm_steps_and_resumes(tmp_path):
    from repro_torch import configs

    mod = load_example("train_lm")
    small = ["--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
             "--device", "cpu", "--log-every", "1"]
    with contextlib.redirect_stdout(io.StringIO()):
        got = mod.main(["--steps", "2"] + small)
        again = mod.main(["--steps", "3"] + small)
    assert got["arch"] == "smollm-100m" and "smollm-100m" in configs.ARCHS
    assert got["params"] >= mod.config_100m().param_count()
    assert (got["start"], got["steps_run"]) == (0, 2)
    assert got["finite"] and all(math.isfinite(x) for x in got["losses"])
    assert (again["start"], again["steps_run"]) == (2, 1)


@pytest.mark.parametrize("name", ["serve_lm", "train_lm"])
def test_the_card_is_the_default(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    argv = ["--steps", "1", "--ckpt-dir", str(tmp_path)] \
        if name == "train_lm" else []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_example(name).main(argv)

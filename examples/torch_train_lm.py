"""End-to-end training on the PyTorch port: train a small smollm-family
model for a few hundred steps on synthetic data, with checkpointing.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]

A thin wrapper over the port's launcher (``repro_torch.launch.train``:
``main`` is ``train(parse_args(argv))``, called here for its numbers);
pass --arch/--batch/--seq/--ckpt-dir to explore, later flags winning.
The JAX example's "~100M" config, registered in
``repro_torch.configs.ARCHS`` as ``smollm-100m``: the smollm trunk at 12
layers × d=512, f32 (42.0 M parameters counted, embeddings tied). Without
--arch it trains that for 300 steps of 8 × 128 tokens and checkpoints
to ``repro_torch_ckpt_100m`` under the temporary directory (a second
run resumes from it). ``--device`` defaults to the card and raises
without one.
"""
import math
import os
import sys
import tempfile

from repro_torch import configs
from repro_torch.launch.train import parse_args, train

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt_100m")


def config_100m():
    """smollm-360m's trunk cut to the JAX example's ~100M config."""
    return configs.get_config("smollm-360m").replace(
        name="smollm-100m", n_layers=12, d_model=512, n_heads=8,
        n_kv_heads=4, head_dim=64, d_ff=1536, vocab=8192,
        param_dtype="float32", compute_dtype="float32", remat=False,
        act_shard="none")


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--arch") for a in argv):
        configs.ARCHS["smollm-100m"] = config_100m()
        argv = ["--arch", "smollm-100m", "--steps", "300", "--batch", "8",
                "--seq", "128", "--ckpt-dir", CKPT_DIR] + argv
    out = train(parse_args(argv))
    losses = out["losses"]
    n_params = sum(p.numel() for p in out["model"].parameters())
    return {"arch": out["cfg"].name, "params": n_params,
            "start": out["start"], "steps_run": len(losses),
            "losses": losses,
            "finite": all(math.isfinite(x) for x in losses)}


if __name__ == "__main__":
    main()

"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 300 --batch 8 --seq 128 --reduced --device cpu \\
        --ckpt-dir /tmp/ckpt

Port of ``repro.launch.train``, with its flags and log lines, plus
``--device`` (default ``cuda``; without a card pass ``--device cpu``).
``--reduced`` takes the same family at small dims. Features: cosine LR,
grad clipping, async step-sharded checkpoints every ``--ckpt-every``
steps with auto-resume from ``--ckpt-dir``, loss / ema / lr / gnorm /
tokens-per-second logging, deterministic synthetic data. As in the
reference, a resumed run starts its data stream from the seed again.

:func:`main` returns 0; :func:`train` returns the run's state and
numbers (``chip_smoke.py`` and the tests call it).
"""
from __future__ import annotations

import argparse
import time

import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="smollm-360m")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--reduced", action="store_true",
                   help="shrunken same-family config (CPU-friendly)")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def train(args: argparse.Namespace) -> dict:
    """Run the launcher. Returns {"cfg", "model", "opt_state", "start" (the
    step resumed from, 0 if none), "losses" (one per step run, floats),
    "step_s" ([(step, seconds per step)] at each log line),
    "tokens_per_step"}."""
    from ..configs import get_config, reduced
    from ..data import synthetic_lm_batches
    from ..device import resolve_device, synchronize
    from ..models import get_model
    from ..train import adamw_init, make_train_step
    from ..train.checkpoint import async_save, latest_step, restore
    from ..train.optimizer import AdamWConfig

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mod = get_model(cfg)
    opt_cfg = AdamWConfig(lr=args.lr)
    step_fn = make_train_step(cfg, opt_cfg, total_steps=args.steps)

    params = mod.init(cfg, torch.Generator(dev).manual_seed(args.seed),
                      device=dev)
    opt_state = adamw_init(params, opt_cfg)
    start = 0
    saver = None
    if args.ckpt_dir:
        saver = async_save(args.ckpt_dir)
        if latest_step(args.ckpt_dir) is not None:
            state, start = restore(args.ckpt_dir, device=dev)
            load_state(params, opt_state, state)
            print(f"resumed from step {start}")

    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} family={cfg.family} params={n_params:,} "
          f"device={torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")

    data = synthetic_lm_batches(cfg.vocab, args.batch, args.seq, args.seed)
    tokens_per_step = args.batch * args.seq
    losses, step_s = [], []
    synchronize([dev])
    t_last, ema = time.perf_counter(), None
    for i, batch in zip(range(start, args.steps), data):
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        if cfg.family == "vlm":
            tb["patches"] = torch.zeros((args.batch, cfg.n_patches,
                                         cfg.d_model), device=dev)
        if cfg.family == "audio":
            tb["frames"] = torch.zeros((args.batch, cfg.n_audio_frames,
                                        cfg.d_model), device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, tb)
        losses.append(metrics["loss"])
        if (i + 1) % args.log_every == 0 or i == start:
            loss = float(metrics["loss"])
            dt = (time.perf_counter() - t_last) / (
                args.log_every if i > start else 1)
            t_last = time.perf_counter()
            step_s.append((i + 1, dt))
            ema = loss if ema is None else 0.9 * ema + 0.1 * loss
            print(f"step {i + 1:5d}  loss {loss:.4f}  ema {ema:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  gnorm "
                  f"{float(metrics['grad_norm']):.2f}  "
                  f"{tokens_per_step / max(dt, 1e-9):,.0f} tok/s", flush=True)
        if saver and (i + 1) % args.ckpt_every == 0:
            saver(state_tree(params, opt_state), i + 1)
    if saver:
        saver(state_tree(params, opt_state), args.steps)
        saver.wait()
        print(f"checkpointed to {args.ckpt_dir}")
    return {"cfg": cfg, "model": params, "opt_state": opt_state,
            "start": start, "losses": [float(x) for x in losses],
            "step_s": step_s, "tokens_per_step": tokens_per_step}


def state_tree(params, opt_state) -> dict:
    """The checkpoint tree: parameters by name, and the optimizer state."""
    return {"params": dict(params.named_parameters()), "opt": opt_state}


@torch.no_grad()
def load_state(params, opt_state, state) -> None:
    """Copy a restored :func:`state_tree` into ``params`` and
    ``opt_state`` (in place, onto their devices and dtypes)."""
    for name, p in params.named_parameters():
        p.copy_(state["params"][name])
    for key in ("m", "v"):
        for name, t in opt_state[key].items():
            t.copy_(state["opt"][key][name])
    opt_state["step"] = state["opt"]["step"].to("cpu", torch.int32)


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Serving example on the PyTorch port: batched prefill + autoregressive
decode with a KV cache, through ``repro_torch.serve.generate``.

    PYTHONPATH=src python examples/torch_serve_lm.py [--tokens 32] [--batch 4] [--device cpu]

The model is ``reduced(get_config(arch))`` with random weights from seed
0; temperature sampling draws from an explicit ``torch.Generator`` (seed
1) on the device. ``--device`` defaults to the card and raises without
one.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import get_model
from repro_torch.serve import generate


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("--arch", default="smollm-360m")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced(get_config(args.arch))
    model = get_model(cfg).init(cfg, torch.Generator(dev).manual_seed(0),
                                device=dev)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))).to(dev)}

    t0 = time.perf_counter()
    out = generate(model, cfg, batch, max_new_tokens=args.tokens,
                   temperature=args.temperature,
                   generator=torch.Generator(dev).manual_seed(1), device=dev)
    synchronize([dev])
    dt = time.perf_counter() - t0
    total = args.batch * args.tokens
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"new={args.tokens}")
    print(f"generated {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, first call)")
    sample = out[0].cpu().tolist()[:16]
    print("sample token ids:", sample)
    return {"arch": cfg.name, "shape": list(out.shape), "vocab": cfg.vocab,
            "min_token": int(out.min()), "max_token": int(out.max()),
            "sample": sample}


if __name__ == "__main__":
    main()

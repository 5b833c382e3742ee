"""Serving launcher: batched generation demo (PyTorch port).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
      --batch 4 --prompt-len 32 --new-tokens 16 [--smoke] [--device cpu]

Weights come from ``init_params(cfg, prng.PRNGKey(seed), device)``, the
JAX package's weights for the same ``--seed``; prompts are drawn from
``np.random.default_rng(seed)``, as the JAX package's launcher draws
them.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import registry
from repro_torch.core import prng
from repro_torch.models import lm
from repro_torch.serve.engine import Engine, ServeConfig


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """(cfg, engine, prompts) for parsed launcher arguments."""
    entry = registry.get(args.arch)
    if entry.is_encdec:
        raise SystemExit("enc-dec serving: see examples/serve_batched.py")
    cfg = entry.smoke() if args.smoke else entry.config
    model = lm.init_params(cfg, prng.PRNGKey(args.seed), args.device)
    eng = Engine(cfg, model,
                 ServeConfig(max_new_tokens=args.new_tokens,
                             temperature=args.temperature, seed=args.seed),
                 device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=args.prompt_len))
               for _ in range(args.batch)]
    return cfg, eng, prompts


def main(argv=None) -> int:
    args = parse_args(argv)
    _, eng, prompts = build(args)
    t0 = time.time()
    out = eng.generate(prompts)
    dt = time.time() - t0
    total = args.batch * args.new_tokens
    print(f"generated {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s batched)")
    for i, o in enumerate(out[:2]):
        print(f"  sample {i}: {o}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

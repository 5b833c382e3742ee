"""Training launcher (PyTorch port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ck \\
      [--resume] [--device cpu]

Data- and tensor-parallel over N processes, started by torchrun (gloo
with ``--device cpu``, NCCL on the cards, one card a rank):

  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --arch granite-3-2b \\
      --smoke --steps 4 --mesh-shape 2,2 --device cpu

``--smoke`` uses the reduced per-family config; without it the full
config trains (gemma2-2b fits one card with AdamW in bf16).  The minicpm
preset uses the WSD schedule per its paper.  Runs on the card unless
``--device cpu``.  Under torchrun (``WORLD_SIZE`` above 1) the process
group starts from the environment and the mesh defaults to (world, 1);
``--mesh-shape`` (data, model) must then hold the world's ranks; a model
axis above 1 trains tensor-parallel over it.
"""

from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.launch.mesh import init_distributed
from repro_torch.train import data as data_lib
from repro_torch.train import optim, schedules
from repro_torch.train.loop import Trainer, TrainerConfig


def lr_for(arch_id: str, lr: float, steps: int):
    if arch_id.startswith("minicpm"):
        return schedules.wsd(lr, max(steps // 20, 1),
                             int(steps * 0.7), int(steps * 0.25))
    return schedules.cosine(lr, max(steps // 20, 1), steps)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 2,2 -> (data,model); default one device, "
                         "or (world, 1) under torchrun")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def build(args: argparse.Namespace) -> Trainer:
    """The :class:`Trainer` for parsed launcher arguments."""
    entry = registry.get(args.arch)
    if entry.is_encdec:
        raise SystemExit("this launcher trains decoder-only archs; "
                         "train enc-dec models through Trainer directly")
    cfg = entry.smoke() if args.smoke else entry.config
    init_distributed(args.device)
    mesh = (tuple(int(x) for x in args.mesh_shape.split(","))
            if args.mesh_shape else None)
    if mesh is None and dist.is_initialized() and dist.get_world_size() > 1:
        mesh = (dist.get_world_size(), 1)
    opt = optim.for_arch(cfg.param_count(), lr_for(args.arch, args.lr,
                                                   args.steps))
    data = data_lib.SyntheticLM(data_lib.LMTaskConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))
    tcfg = TrainerConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, resume=args.resume,
        num_microbatches=args.microbatches,
        compress_grads=args.compress_grads, seed=args.seed)
    return Trainer(cfg, mesh, opt, data, tcfg, device=args.device)


def main(argv=None) -> int:
    started_here = not dist.is_initialized()
    trainer = build(parse_args(argv))
    hist = trainer.run()
    if trainer.lead:
        print(f"final loss: {hist[-1]['loss']:.4f} "
              f"(straggler events: {len(trainer.monitor.events)})")
    if started_here and dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Runs the fault-tolerant :class:`~repro_torch.runtime.trainer.Trainer` on
the deterministic token stream, on the card unless ``--device cpu``.
``--reduced`` trains the small twin of the architecture in float32; the
full one computes in bfloat16.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
      --reduced --steps 50 --batch 8 --seq 64 --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import TokenStream
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="the small twin of the architecture (float32)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="per-host batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' trains on the CPU)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 production mesh (ROADMAP A11)")
    args = ap.parse_args(argv)
    if args.production_mesh:
        raise SystemExit("--production-mesh: multi-device training is not "
                         "ported yet (ROADMAP A11)")

    cfg = get_config(args.arch, reduced=args.reduced)
    stream = TokenStream(vocab_size=cfg.vocab_size, batch_size=args.batch,
                         seq_len=args.seq)
    trainer = Trainer(
        cfg,
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps,
                      compute_dtype=torch.float32 if args.reduced
                      else torch.bfloat16),
        stream.batch, device=args.device)
    out = trainer.run(args.steps)
    losses = out["losses"]
    print(f"finished at step {out['final_step']}: "
          f"loss {losses[0]:.4f} → {losses[-1]:.4f}; "
          f"recoveries={out['recoveries']} stragglers={out['stragglers']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Runs the fault-tolerant :class:`~repro_torch.runtime.trainer.Trainer` on
the deterministic token stream, on the card unless ``--device cpu``.
``--reduced`` trains the small twin of the architecture in float32; the
full one computes in bfloat16.  ``--production-mesh`` trains on the 16×16
``("data", "model")`` mesh: 256 ranks, one per device, started by
``torchrun --nproc-per-node …`` (a world of another size raises); rank 0
prints.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
      --reduced --steps 50 --batch 8 --seq 64 --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import TokenStream
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.runtime.trainer import Trainer, TrainerConfig

PRODUCTION_MESH = "16x16"  # launch/mesh.py::make_production_mesh's shape


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
                    help="train on the 16x16 mesh (256 ranks)")
    args = ap.parse_args(argv)
    # the strict mesh: a world of another size than 256 raises
    mesh = (make_serve_mesh(PRODUCTION_MESH, args.device)
            if args.production_mesh else None)

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
        stream.batch, mesh=mesh, device=args.device)
    out = trainer.run(args.steps)
    if mesh is not None and dist.get_rank() != 0:
        return 0
    losses = out["losses"]
    print(f"finished at step {out['final_step']}: "
          f"loss {losses[0]:.4f} → {losses[-1]:.4f}; "
          f"recoveries={out['recoveries']} stragglers={out['stragglers']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

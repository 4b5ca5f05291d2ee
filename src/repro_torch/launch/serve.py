"""Serving launcher of the port: ``python -m repro_torch.launch.serve``.

Random-initialises serving params from a seeded ``torch.Generator`` on the
device and drives the paged continuous-batching engine over a synthetic
request stream; with ``--amm`` the MLPs run through the LUT-MU path.

Examples:
  # on the card, full width
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --amm

  # on the CPU, reduced widths (the kernels' plain versions)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
      --reduced --amm --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import model as MD
from repro_torch.serving import load_engine


def cli_prompts(prompt_specs, n_requests: int, vocab_size: int):
    """``--prompt`` token lists when given, else ``n_requests`` synthetic
    8-token prompts from the deterministic TokenStream (the JAX launcher's
    prompts)."""
    if prompt_specs:
        out = []
        for spec in prompt_specs:
            try:
                out.append([int(t) for t in spec.replace(",", " ").split()])
            except ValueError:
                raise SystemExit(f"--prompt must be token ids, got {spec!r}")
        return out
    stream = TokenStream(vocab_size=vocab_size, batch_size=1, seq_len=16)
    return [[int(t) for t in stream.batch(i)["tokens"][0][:8]]
            for i in range(n_requests)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--amm", action="store_true",
                    help="serve MLPs through the LUT-MU path")
    ap.add_argument("--amm-backend", default="auto",
                    choices=("auto", "ref", "unfused", "fused"),
                    help="LUT-MU engine backend (kernels.dispatch); 'auto' "
                         "picks per dtype/device")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=2,
                    help="decode batch rows")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV-cache page size (tokens per page)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens prefilled per engine step")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="KV page-pool size; smaller than "
                         "max_batch*ceil(max_len/page_size) turns on "
                         "eviction (host swap) under pressure")
    ap.add_argument("--prompt", action="append", metavar="TOKENS",
                    help="explicit prompt as space/comma-separated token ids "
                         "(repeatable); replaces the synthetic requests")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.amm:
        cfg = dataclasses.replace(
            cfg, amm=dataclasses.replace(cfg.amm, enabled=True,
                                         backend=args.amm_backend))
    dtype = torch.float32 if args.reduced else torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(0)
    params = MD.init_params(cfg, gen, dtype, serving=args.amm)
    engine = load_engine(None, params, cfg, max_batch=args.max_batch,
                         max_len=args.max_len, page_size=args.page_size,
                         prefill_chunk=args.prefill_chunk,
                         num_pages=args.num_pages, compute_dtype=dtype,
                         device=device)
    for prompt in cli_prompts(args.prompt, args.requests, cfg.vocab_size):
        engine.submit(prompt, max_new_tokens=args.max_new)
    t0 = time.time()
    done = engine.run_until_drained()
    dt = time.time() - t0
    n_tok = sum(len(r.generated) for r in done)
    print(f"{len(done)} requests, {n_tok} tokens, {dt:.1f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s) on {device}")
    for r in done:
        print(f"  req {r.uid}: {r.prompt} → {r.generated}")


if __name__ == "__main__":
    main()

"""AdamW with decoupled weight decay, and schedules, as in
``repro.optim.adamw``.

It works on nested param dicts (not ``torch.optim``), so the leaf order and
the checkpoint layout are the JAX package's.  Master params and moments are
float32; the update is the reference's arithmetic, op for op (``b2 =
0.95``, decay on every leaf).  Clipping and the update overwrite the
gradients, params and moments they are given, as the reference's donated
buffers: a full-width model keeps no second copy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

from repro_torch import pytree as T

Tensor = torch.Tensor
Tree = Any


@dataclasses.dataclass
class AdamWState(T.Node):
    step: Tensor  # () int32
    mu: Tree
    nu: Tree


def adamw_init(params: Tree) -> AdamWState:
    def zeros(p):
        return T.map_tree(lambda a: torch.zeros_like(a, dtype=torch.float32),
                          p)
    dev = T.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros(params), nu=zeros(params))


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int
                    ) -> Callable[[Tensor], Tensor]:
    """Linear warm-up, then cosine decay to 0 (float32, on the step's
    device)."""
    def lr_at(step: Tensor) -> Tensor:
        step = step.to(torch.float32)
        warm = base_lr * (step + 1.0) / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos)
    return lr_at


def clip_by_global_norm(grads: Tree, max_norm: float,
                        par=None) -> Tuple[Tree, Tensor]:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns them and the norm before clipping.

    On a mesh (``par``, a ``ParallelContext``; ``grads`` a rank's shards of
    the params' gradients, reduced) each leaf's sum of squares is summed
    over the ranks holding its parts (``par.global_sums``), so the norm
    counts every element of the whole gradient once."""
    named = T.leaves_with_paths(grads)
    sums = [torch.sum(torch.square(g.to(torch.float32))) for _, g in named]
    if par is not None:
        sums = par.global_sums([p for p, _ in named], sums)
    total = 0
    for s in sums:
        total = total + s
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in T.leaves(grads):
        g.mul_(scale)
    return grads, gn


def adamw_update(params: Tree, grads: Tree, state: AdamWState, lr, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Tree, AdamWState]:
    """One AdamW step that overwrites ``params`` and ``state``'s moments;
    returns them with the new step count."""
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - b1**t
    c2 = 1.0 - b2**t
    for p, g, m, v in zip(T.leaves(params), T.leaves(grads),
                          T.leaves(state.mu), T.leaves(state.nu)):
        g = g.to(torch.float32)
        pf = p.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_(((1 - b2) * g).mul_(g))
        delta = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * pf
        p.copy_(pf - lr * delta)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)

"""Train steps, as in ``repro.runtime.steps``.

``make_train_step`` builds the step the trainer runs: the loss of
``models.model.forward`` in the compute dtype (float32 master weights of
two or more dims cast first), float32 gradients accumulated over
``cfg.grad_accum`` microbatches, global-norm clipping and AdamW.  The
prefill and decode step builders wait for the non-paged serving path
(ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import pytree as T
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm

Tensor = torch.Tensor
Tree = Any


@dataclasses.dataclass
class TrainState(T.Node):
    params: Tree
    opt: Any  # AdamWState
    step: Tensor  # () int32


def init_train_state(cfg: ModelConfig, gen: torch.Generator,
                     dtype=torch.float32) -> TrainState:
    params = MD.init_params(cfg, gen, dtype)
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=gen.device))


def make_loss_fn(cfg: ModelConfig, remat: bool = True,
                 compute_dtype=torch.bfloat16):
    def loss_fn(params, batch):
        if compute_dtype != torch.float32:
            # cast the master weights to the compute dtype before the
            # stack, as the reference does
            params = T.map_tree(
                lambda a: a.to(compute_dtype)
                if a.dtype == torch.float32 and a.dim() >= 2 else a, params)
        logits = MD.forward(params, batch["tokens"], cfg, remat=remat,
                            compute_dtype=compute_dtype)
        return L.softmax_cross_entropy(logits, batch["labels"])
    return loss_fn


def make_train_step(cfg: ModelConfig, lr_schedule: Callable[[Tensor], Tensor],
                    remat: bool = True, compute_dtype=torch.bfloat16,
                    max_grad_norm: float = 1.0):
    """Build the train step ``(state, batch) → (state, metrics)``.

    ``cfg.grad_accum > 1`` splits the batch into that many microbatches
    (when it divides the batch) and sums their float32 gradients before
    one optimizer update.  The step overwrites the params and moments of
    the state it is given, as the reference's donated buffers, and returns
    them in a new state."""
    loss_fn = make_loss_fn(cfg, remat, compute_dtype)
    accum = max(int(cfg.grad_accum), 1)

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
        loss = loss_fn(T.unflatten_like(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), [g.to(torch.float32) for g in grads]

    def train_step(state: TrainState, batch: dict):
        n = batch["tokens"].shape[0]
        accum_eff = accum if n % accum == 0 else 1
        if accum_eff > 1:
            mb = n // accum_eff
            gsum, losses = None, []
            for i in range(accum_eff):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, g = grads_of(state.params, micro)
                losses.append(loss)
                if gsum is None:
                    gsum = g
                else:
                    for a, b in zip(gsum, g):
                        a.add_(b)
                del g
            for a in gsum:
                a.div_(accum_eff)
            loss = torch.stack(losses).mean()
        else:
            loss, gsum = grads_of(state.params, batch)
        grads = T.unflatten_like(state.params, gsum)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_schedule(state.step)
        with torch.no_grad():
            params, opt = adamw_update(state.params, grads, state.opt, lr)
        del grads, gsum
        new_state = TrainState(params=params, opt=opt, step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step

"""Train, prefill and decode steps, as in ``repro.runtime.steps``.

``make_train_step`` builds the step the trainer runs: the loss of
``models.model.forward`` in the compute dtype (float32 master weights of
two or more dims cast first), float32 gradients accumulated over
``cfg.grad_accum`` microbatches, global-norm clipping and AdamW; with a
``ParallelContext`` (``par``) one rank's share of it on a mesh.
``make_prefill_step`` and ``make_decode_step`` build the fixed-slot
cache's serving steps (``models.model.prefill`` and ``decode_step``);
a batch's ``"frontend"`` entry is the frontend embeddings (Whisper's
frames, a VLM's patches).
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
                     dtype=torch.float32, shard=None) -> TrainState:
    """The initial state; ``shard`` as ``init_params`` takes it (the
    optimizer's moments follow the params' shapes)."""
    params = MD.init_params(cfg, gen, dtype, shard=shard)
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=gen.device))


def make_loss_fn(cfg: ModelConfig, remat: bool = True,
                 compute_dtype=torch.bfloat16, par=None):
    """``(params, batch) → loss``: the mean cross-entropy of the batch's
    rows.  On a mesh (``par``) ``params`` are a rank's shards and ``batch``
    its data rank's rows."""
    def loss_fn(params, batch):
        if compute_dtype != torch.float32:
            # cast the master weights to the compute dtype before the
            # stack, as the reference does
            params = T.map_tree(
                lambda a: a.to(compute_dtype)
                if a.dtype == torch.float32 and a.dim() >= 2 else a, params)
        logits = MD.forward(params, batch["tokens"], cfg, remat=remat,
                            extra_embeds=batch.get("frontend"),
                            compute_dtype=compute_dtype, par=par)
        return L.softmax_cross_entropy(logits, batch["labels"])
    return loss_fn


def make_grad_fn(cfg: ModelConfig, remat: bool = True,
                 compute_dtype=torch.bfloat16, par=None):
    """Build ``(params, batch) → (loss, grads)``: the mean loss and the
    float32 gradients (a list in flatten order) a train step applies.

    ``cfg.grad_accum > 1`` splits the batch into that many microbatches
    (when it divides the batch) and averages their gradients.  On a mesh
    (``par``) ``params`` are the rank's shards and ``batch`` the whole
    global batch: the rank takes its data rank's rows, and the gradients
    are reduced by ``par.reduce_grads`` (the rule is ``grad_sum_axes``),
    so loss and gradients are those of the mean over the global batch,
    each gradient the rank's shard of the whole one."""
    loss_fn = make_loss_fn(cfg, remat, compute_dtype, par)
    accum = max(int(cfg.grad_accum), 1)

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
        loss = loss_fn(T.unflatten_like(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), [g.to(torch.float32) for g in grads]

    def grad_fn(params, batch: dict):
        if par is not None:
            batch = {k: par.local_rows(v) for k, v in batch.items()}
        n = batch["tokens"].shape[0]
        accum_eff = accum if n % accum == 0 else 1
        if accum_eff > 1:
            mb = n // accum_eff
            gsum, losses = None, []
            for i in range(accum_eff):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, g = grads_of(params, micro)
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
            loss, gsum = grads_of(params, batch)
        if par is not None:
            par.reduce_grads([p for p, _ in T.leaves_with_paths(params)],
                             gsum)
            loss = par.mean_over_data(loss)
        return loss, gsum

    return grad_fn


def make_train_step(cfg: ModelConfig, lr_schedule: Callable[[Tensor], Tensor],
                    remat: bool = True, compute_dtype=torch.bfloat16,
                    max_grad_norm: float = 1.0, par=None):
    """Build the train step ``(state, batch) → (state, metrics)``:
    :func:`make_grad_fn`'s gradients, global-norm clipping and AdamW.  The
    step overwrites the params and moments of the state it is given, as
    the reference's donated buffers, and returns them in a new state.

    On a mesh (``par``) the state is the rank's shards
    (``distributed.sharding.shard_state``) and ``batch`` the whole global
    batch; clipping counts every element of the whole gradient once, and
    AdamW runs on the local shards."""
    grad_fn = make_grad_fn(cfg, remat, compute_dtype, par)

    def train_step(state: TrainState, batch: dict):
        loss, gsum = grad_fn(state.params, batch)
        grads = T.unflatten_like(state.params, gsum)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm, par)
        lr = lr_schedule(state.step)
        with torch.no_grad():
            params, opt = adamw_update(state.params, grads, state.opt, lr)
        del grads, gsum
        new_state = TrainState(params=params, opt=opt, step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int,
                      compute_dtype=torch.bfloat16, par=None):
    """``(params, batch) → (logits (B, 1, V), cache)``: the prompts of
    ``batch["tokens"]`` (and ``batch["frontend"]`` where the family takes
    one) into a fresh cache of ``max_len`` positions; on a mesh (``par``)
    one rank's share (``models.model.prefill``): ``batch`` is the whole
    batch, the rank computes its data rank's rows when they split over
    ``data`` and returns the whole batch's logits and its rows' cache."""
    def prefill_step(params, batch):
        return MD.prefill(params, batch["tokens"], cfg, max_len,
                          extra_embeds=batch.get("frontend"),
                          compute_dtype=compute_dtype, par=par)
    return prefill_step


def make_decode_step(cfg: ModelConfig, compute_dtype=torch.bfloat16,
                     par=None):
    """``(params, token, pos, cache) → logits (B, 1, V)``, the cache
    advanced in place; on a mesh (``par``) one rank's share
    (``models.model.decode_step``): ``cache`` is the rank's part, placed
    by ``par.place_cache`` (a cut sequence read by the partial
    softmax)."""
    def decode_step(params, token, pos, cache):
        return MD.decode_step(params, token, pos, cache, cfg,
                              compute_dtype=compute_dtype, par=par)
    return decode_step

"""Carry JAX params, train states and configs across to the port, and the
port's trees back as numpy arrays.

``params_from_jax`` turns a JAX params tree — a nested dict whose leaves
are arrays (numpy, or anything ``np.asarray`` takes): the LM's, with layers
stacked on axis 0 and weights ``(D, H·hd)``, or the case studies' MLP and
ResNet-9 dicts (convolutions HWIO) — into the port's params with the same
layout, so both packages compute the same function on the same tables.
``train_state_from_jax`` does the same for a ``TrainState`` and its
``AdamWState``.
Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import AMMConfig, ModelConfig


def to_tensor(a, device: torch.device) -> torch.Tensor:
    """An array (numpy, or anything ``np.asarray`` takes) → a tensor of the
    same dtype on ``device``, owning its memory."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def params_from_jax(tree, device="cuda"):
    """Nested dict of arrays → the same nested dict of torch tensors on
    ``device`` (dtypes kept, bfloat16 included)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return to_tensor(tree, dev)


def train_state_from_jax(state, device="cuda"):
    """A JAX ``TrainState`` (params, ``AdamWState`` opt, step) → the port's
    ``TrainState`` on ``device``, every leaf's dtype kept."""
    from repro_torch.optim import AdamWState  # no cycle at import
    from repro_torch.runtime.steps import TrainState

    dev = resolve_device(device)
    opt = state.opt
    return TrainState(
        params=params_from_jax(state.params, dev),
        opt=AdamWState(step=to_tensor(opt.step, dev),
                       mu=params_from_jax(opt.mu, dev),
                       nu=params_from_jax(opt.nu, dev)),
        step=to_tensor(state.step, dev))


def config_from_jax(cfg) -> ModelConfig:
    """A JAX ``ModelConfig`` (or any dataclass with its fields) → the
    port's own ``ModelConfig``."""
    fields = dataclasses.asdict(cfg)
    fields["amm"] = AMMConfig(**fields["amm"])
    return ModelConfig(**fields)

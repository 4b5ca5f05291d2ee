"""Carry JAX params and configs across to the port.

``params_from_jax`` turns the JAX params tree — a nested dict whose leaves
are arrays (numpy, or anything ``np.asarray`` takes), layers stacked on
axis 0, weights ``(D, H·hd)`` — into the port's params with the same
layout, so both packages compute the same function on the same tables.
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


def config_from_jax(cfg) -> ModelConfig:
    """A JAX ``ModelConfig`` (or any dataclass with its fields) → the
    port's own ``ModelConfig``."""
    fields = dataclasses.asdict(cfg)
    fields["amm"] = AMMConfig(**fields["amm"])
    return ModelConfig(**fields)

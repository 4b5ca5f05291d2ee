"""Differentiable LUT-MU for layer-wise retraining (paper Section VI-B), as
in ``repro.core.ste``.

MADDNESS's tree encode is not differentiable; the paper's fix (via [25]) is
a straight-through estimator:

  * forward — the exact LUT-MU path: encode to a float32 one-hot, then the
    one-hot × LUT aggregation.  On CUDA tensors these are the port's
    ``encode_onehot`` and ``lut_aggregate`` kernels; on CPU tensors their
    plain versions (``core/maddness.py``'s one-hot path);
  * backward — to the LUT through the one-hot selection, exact
    (``d_lut = einsum("bcp,bn->cpn")``: the aggregation is linear in the
    LUT), and to the input through the dense surrogate ``x @ W``
    (``d_x = g @ Wᵀ``).  The JAX package computes both outside any Pallas
    kernel, so they stay ``torch.einsum`` / ``torch.matmul`` here.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import maddness as M
from repro_torch.kernels.lut_aggregate import lut_aggregate
from repro_torch.kernels.maddness_encode import encode_onehot

Tensor = torch.Tensor


def encode_float_onehot(x: Tensor, tree: M.HashTree) -> Tensor:
    """(B, D) → (B, C, G) float32 one-hot (the encode kernel on CUDA)."""
    xs = M.gather_split_values(x, tree).to(torch.float32).contiguous()
    return encode_onehot(xs, tree.thresholds.contiguous())


def _aggregate(onehot: Tensor, lut: Tensor) -> Tensor:
    """One-hot × LUT with a unit epilogue (the aggregate kernel on CUDA)."""
    n = lut.shape[-1]
    return lut_aggregate(
        onehot, lut.contiguous(),
        torch.ones((), dtype=torch.float32, device=lut.device),
        torch.zeros((n,), dtype=torch.float32, device=lut.device))


def _lut_grad(onehot: Tensor, g: Tensor) -> Tensor:
    return torch.einsum("bcp,bn->cpn", onehot, g.to(torch.float32))


class OneHotAggregate(torch.autograd.Function):
    """``out = Σ_{c,p} onehot[b,c,p] · lut[c,p,n]``, differentiable in the
    LUT (the one-hot is a constant)."""

    @staticmethod
    def forward(ctx, onehot: Tensor, lut: Tensor) -> Tensor:
        ctx.save_for_backward(onehot)
        return _aggregate(onehot, lut)

    @staticmethod
    def backward(ctx, g: Tensor):
        (onehot,) = ctx.saved_tensors
        return None, _lut_grad(onehot, g)


class STELutMatmul(torch.autograd.Function):
    """The straight-through LUT-MU: see the module docstring."""

    @staticmethod
    def forward(ctx, x: Tensor, lut: Tensor, surrogate_w: Tensor,
                split_dims: Tensor, thresholds: Tensor) -> Tensor:
        onehot = encode_float_onehot(x, M.HashTree(split_dims, thresholds))
        ctx.save_for_backward(onehot, surrogate_w)
        return _aggregate(onehot, lut)

    @staticmethod
    def backward(ctx, g: Tensor):
        onehot, surrogate_w = ctx.saved_tensors
        d_x = g @ surrogate_w.T if ctx.needs_input_grad[0] else None
        d_lut = _lut_grad(onehot, g) if ctx.needs_input_grad[1] else None
        d_w = (torch.zeros_like(surrogate_w) if ctx.needs_input_grad[2]
               else None)
        return d_x, d_lut, d_w, None, None


def ste_lut_matmul(x: Tensor, lut: Tensor, surrogate_w: Tensor,
                   split_dims: Tensor, thresholds: Tensor) -> Tensor:
    """Approximate ``x @ W`` with a trainable ``lut``; STE back to ``x``.

    Args:
      x: (B, D) float32.
      lut: (C, G, N) float32 — trainable.
      surrogate_w: (D, N) float32 — the dense surrogate of the input
        gradient (typically the original weight).
      split_dims / thresholds: the frozen trees.
    """
    return STELutMatmul.apply(x, lut, surrogate_w, split_dims, thresholds)


def retrain_lut_layerwise(x_calib: Tensor, target: Tensor, lut: Tensor,
                          surrogate_w: Tensor, split_dims: Tensor,
                          thresholds: Tensor, steps: int = 100,
                          lr: float = 1e-2) -> Tuple[Tensor, Tensor]:
    """Minimise ``mean((ste_lut_matmul(x) - target)²)`` over the LUT
    entries by plain gradient descent.  Returns ``(lut, losses)``."""
    lut = lut.detach()
    losses = []
    for _ in range(steps):
        lut_ = lut.requires_grad_(True)
        y = ste_lut_matmul(x_calib, lut_, surrogate_w, split_dims, thresholds)
        loss = torch.mean((y - target) ** 2)
        (g,) = torch.autograd.grad(loss, lut_)
        lut = (lut_ - lr * g).detach()
        losses.append(loss.detach())
    return lut, torch.stack(losses)

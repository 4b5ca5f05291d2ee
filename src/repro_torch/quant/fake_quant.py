"""FINN-style quantisation baseline (the paper's MVAU comparison point), as
in ``repro.quant.fake_quant``:

  * :func:`fake_quant` — uniform symmetric fake quantisation with a
    straight-through gradient (the INT4 base models the paper starts from).
    ``torch.round`` rounds half to even, as ``jnp.round`` does;
  * :func:`successive_threshold` — the FINN "streamlined" non-linearity:
    scale + batch norm + quantised activation collapsed into a monotone
    stack of threshold comparisons (paper Fig. 8).
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, bits: int, scale) -> Tensor:
        n = 2 ** (bits - 1) - 1
        q = torch.clamp(torch.round(x / scale * n), -n - 1, n)
        return q * scale / n

    @staticmethod
    def backward(ctx, g: Tensor):
        return g, None, None


def fake_quant(x: Tensor, bits: int = 4, scale=1.0) -> Tensor:
    """Uniform symmetric fake quant; the gradient passes straight through
    to ``x``."""
    return _FakeQuant.apply(x, bits, scale)


def thresholds_from_bn(gamma: Tensor, beta: Tensor, mean: Tensor,
                       var: Tensor, bits: int, act_scale: float = 1.0,
                       eps: float = 1e-5) -> Tensor:
    """Collapse scale + BN + quantised ReLU into threshold levels (FINN
    streamline): level k is emitted iff ``BN(x) >= k·step``, so
    ``t_k = mean + (k·step − beta)·σ/γ``.  Returns (levels, channels)."""
    n_levels = 2**bits - 1
    sigma = torch.sqrt(var + eps)
    ks = torch.arange(1, n_levels + 1, dtype=torch.float32,
                      device=gamma.device)[:, None]
    step = act_scale / n_levels
    return mean[None] + (ks * step - beta[None]) * sigma[None] / torch.clamp(
        gamma[None], min=1e-8)


def successive_threshold(x: Tensor, thresholds: Tensor,
                         act_scale: float = 1.0) -> Tensor:
    """out = (#thresholds crossed) · step — a pure comparison stack.
    x: (..., C); thresholds: (levels, C)."""
    n_levels = thresholds.shape[0]
    crossed = (x[..., None, :] >= thresholds).sum(dim=-2)
    return crossed.to(x.dtype) * (act_scale / n_levels)


def quant_params_bits(shape, bits: int) -> int:
    """Parameter footprint of a quantised weight tensor, in bits."""
    return int(np.prod(shape)) * bits

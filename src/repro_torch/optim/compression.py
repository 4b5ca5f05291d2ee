"""int8 gradient compression with error feedback, for the data-parallel
all-reduce, as in ``repro.optim.compression``.

Each leaf is quantised to int8 with a per-leaf max-abs scale after adding
its carried residual; the quantisation error is carried to the next step,
so the compression error is unbiased over steps.  The codes are bitwise
the reference's (IEEE float32 division and round-half-to-even on both
sides).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch import pytree as T

Tensor = torch.Tensor
Tree = Any


@dataclasses.dataclass
class CompressionState(T.Node):
    """Error-feedback residuals, one per grad leaf."""

    residual: Tree


def compression_init(params: Tree) -> CompressionState:
    return CompressionState(residual=T.map_tree(
        lambda a: torch.zeros_like(a, dtype=torch.float32), params))


def _quant_leaf(g: Tensor, r: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    g = g.to(torch.float32) + r
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale, g - q.to(torch.float32) * scale


def compress_gradients(grads: Tree, state: CompressionState
                       ) -> Tuple[Tree, Tree, CompressionState]:
    """Returns (int8 grads, per-leaf scales, updated error-feedback
    state)."""
    out = [_quant_leaf(g, r) for g, r in zip(T.leaves(grads),
                                              T.leaves(state.residual))]
    return (T.unflatten_like(grads, [o[0] for o in out]),
            T.unflatten_like(grads, [o[1] for o in out]),
            CompressionState(residual=T.unflatten_like(
                grads, [o[2] for o in out])))


def dequantize(q: Tree, scales: Tree) -> Tree:
    return T.map_tree(lambda qq, ss: qq.to(torch.float32) * ss, q, scales)

"""Public entry points for the LUT-MU kernels, as ``repro.kernels.ops``.

Each takes a ``MaddnessParams`` bundle (or a tree) and runs one kernel
through its wrapper: CUDA tensors launch it, CPU tensors take its plain
version.  ``tiles`` is an explicit launch plan (``kernels.autotune``);
without one each wrapper plans its own launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.maddness import (HashTree, MaddnessParams,
                                       gather_split_values)
from repro_torch.core.pruning import PruningPlan, pruned_to_split_values
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import fused_lutmu as FL
from repro_torch.kernels import lut_aggregate as LA
from repro_torch.kernels import maddness_encode as ME

Tensor = torch.Tensor


def _on_card(t: Tensor, tiles: Optional[AT.TileConfig]) -> bool:
    return tiles is not None and t.device.type == "cuda"


def encode_onehot(x_split: Tensor, tree: HashTree, *,
                  tiles: Optional[AT.TileConfig] = None,
                  out_dtype=torch.float32) -> Tensor:
    """(B, C, I) split values → (B, C, G) one-hot via the encode kernel."""
    b, c, depth = x_split.shape
    plan = (AT.encode_plan(tiles, b, c, depth) if _on_card(x_split, tiles)
            else None)
    return ME.encode_onehot(x_split.to(torch.float32).contiguous(),
                            tree.thresholds, out_dtype=out_dtype,
                            launch_plan=plan)


def encode_codes(x_split: Tensor, tree: HashTree, **kw) -> Tensor:
    """(B, C, I) → (B, C) int32 prototype ids."""
    return torch.argmax(encode_onehot(x_split, tree, **kw), dim=-1).to(
        torch.int32)


def lut_aggregate(onehot: Tensor, lut: Tensor, lut_scale: Tensor,
                  lut_offset: Tensor, *,
                  tiles: Optional[AT.TileConfig] = None) -> Tensor:
    """(B, C, G) one-hot × (C, G, N) LUT → (B, N) float32."""
    split_k = tiles.split_k if _on_card(lut, tiles) else None
    return LA.lut_aggregate(onehot, lut, lut_scale, lut_offset, split_k)


def fused_lutmu(x_split: Tensor, params: MaddnessParams, *,
                tiles: Optional[AT.TileConfig] = None) -> Tensor:
    """Fused encode + aggregate from split values → (B, N) float32."""
    b, c, depth = x_split.shape
    plan = (AT.fused_plan(tiles, b, c, depth, params.lut.dtype)
            if _on_card(x_split, tiles) else None)
    return FL.fused_lutmu(x_split.to(torch.float32).contiguous(),
                          params.tree.thresholds, params.lut,
                          params.lut_scale, params.lut_offset, plan)


def amm_matmul(x: Tensor, params: MaddnessParams, **kw) -> Tensor:
    """Drop-in ``x @ W`` replacement: full-width input → fused kernel."""
    return fused_lutmu(gather_split_values(x, params.tree), params, **kw)


def amm_matmul_package(x_pruned: Tensor, params: MaddnessParams,
                       plan_codebooks: int, plan_depth: int, **kw) -> Tensor:
    """Chained (data-pruned) input path: cluster-ordered package → output."""
    plan = PruningPlan(torch.zeros((0,), dtype=torch.int64), plan_codebooks,
                       plan_depth)
    return fused_lutmu(pruned_to_split_values(x_pruned, plan), params, **kw)

"""LUT-MU pruning (the paper's Section V-A) in PyTorch.

Three transforms on cascaded MADDNESS matmuls, as in ``repro.core.pruning``:
data pruning (layer *i* only emits the split dims layer *i+1* reads), data
reshape (those values in *cluster order*: level ``l`` of consumer codebook
``c`` at position ``l·C' + c``) and parameter pruning (only the LUT columns
producing them are stored).  Pruning is lossless: the kept values are
bit-identical to the unpruned chain's values at the same dims.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.maddness import HashTree

Tensor = torch.Tensor


@dataclasses.dataclass
class PruningPlan:
    """Static gather plan connecting producer layer *i* → consumer *i+1*.

    Attributes:
      keep_idx: (I'·C',) int64 — absolute output dims of layer *i* to keep,
        in cluster order (position ``l * C' + c`` is the dim read at level
        ``l`` of consumer codebook ``c``).  Duplicates are allowed.
      consumer_codebooks: C'.
      consumer_depth: I'.
    """

    keep_idx: Tensor
    consumer_codebooks: int
    consumer_depth: int

    @property
    def num_kept(self) -> int:
        return self.consumer_codebooks * self.consumer_depth


def plan_from_consumer_tree(consumer_tree: HashTree,
                            consumer_in_dim: int) -> PruningPlan:
    """Build the pruning plan for a producer feeding ``consumer_tree``;
    ``consumer_in_dim`` is the consumer's full input width D'."""
    split_dims = consumer_tree.split_dims.detach().cpu().numpy()  # (C', I')
    c_books, depth = split_dims.shape
    if consumer_in_dim % c_books:
        raise ValueError(f"D'={consumer_in_dim} not divisible by C'={c_books}")
    d_sub = consumer_in_dim // c_books
    base = np.arange(c_books, dtype=np.int64) * d_sub
    abs_dims = split_dims.T.astype(np.int64) + base[None, :]  # (I', C')
    return PruningPlan(
        keep_idx=torch.as_tensor(abs_dims.reshape(-1),
                                 device=consumer_tree.split_dims.device),
        consumer_codebooks=c_books,
        consumer_depth=depth,
    )


def prune_lut(lut: Tensor, lut_offset: Tensor, plan: PruningPlan):
    """Parameter pruning: keep only the LUT columns the consumer reads."""
    return lut[..., plan.keep_idx], lut_offset[..., plan.keep_idx]


def prune_activations(x: Tensor, plan: PruningPlan) -> Tensor:
    """Data pruning + reshape of a full-width activation: (B, D) → (B, I'·C')."""
    return x[..., plan.keep_idx]


def pruned_to_split_values(x_pruned: Tensor, plan: PruningPlan) -> Tensor:
    """Decode the cluster-ordered package into the encode's (B, C', I') input.

    Level ``l`` of codebook ``c`` sits at ``l·C' + c``, so this is a reshape
    to (B, I', C') and a transpose — no gather.
    """
    b = x_pruned.shape[0]
    x = x_pruned.reshape(b, plan.consumer_depth, plan.consumer_codebooks)
    return x.transpose(1, 2)


def workload_ops(num_codebooks: int, depth: int, out_cols: int) -> int:
    """Online op count of one LUT-MU call per input row (paper Fig. 9
    'MOPs'): I comparisons per codebook to encode, C-1 adds per output
    column to aggregate."""
    encode_ops = num_codebooks * depth
    agg_ops = (num_codebooks - 1) * out_cols
    return encode_ops + agg_ops

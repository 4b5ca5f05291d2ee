"""MADDNESS online path (Blalock & Guttag, ICML'21) in PyTorch.

The port of ``repro.core.maddness``'s online half: gather the split values,
encode each codebook's sub-vector to a prototype id (sequential tree walk or
parallel comparators), and aggregate the selected LUT rows.  The offline fit
(hash-tree learning, prototypes, LUT build) stays in the JAX package for now.

Shapes follow the paper: an input of width ``D`` splits into ``C``
codebooks of ``d_sub = D // C`` dims; a depth-``I`` tree per codebook picks
one of ``G = 2**I`` prototypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class HashTree:
    """Per-codebook bisecting decision trees.

    Attributes:
      split_dims: (C, I) int32 — the dim (within the codebook's ``d_sub``
        subspace) compared at each level; all nodes of a level share it.
      thresholds: (C, 2**I - 1) float32 — per-node split values in heap
        order (node 0 = root, level ``l`` occupies ``[2**l - 1, 2**(l+1)-1)``).
    """

    split_dims: Tensor
    thresholds: Tensor

    @property
    def num_codebooks(self) -> int:
        return self.split_dims.shape[0]

    @property
    def depth(self) -> int:
        return self.split_dims.shape[1]

    @property
    def num_prototypes(self) -> int:
        return 2 ** self.depth


@dataclasses.dataclass
class MaddnessParams:
    """Everything needed for one LUT-based approximate matmul ``x @ W``.

    Attributes:
      tree: the hash trees (encode parameters).
      prototypes: (C, G, d_sub) float32, or None — only needed offline.
      lut: (C, G, N) float32/bfloat16, or int8 when quantised.
      lut_scale: () or (N,) float32 dequant scale.
      lut_offset: () or (N,) float32 dequant offset.
    """

    tree: HashTree
    prototypes: Optional[Tensor]
    lut: Tensor
    lut_scale: Tensor
    lut_offset: Tensor

    @property
    def out_features(self) -> int:
        return self.lut.shape[-1]


def gather_split_values(x: Tensor, tree: HashTree) -> Tensor:
    """(B, D) → (B, C, I): the only input values the encode ever reads."""
    b = x.shape[0]
    c_books, depth = tree.split_dims.shape
    xs = x.reshape(b, c_books, x.shape[1] // c_books)
    idx = tree.split_dims.to(torch.int64)[None].expand(b, c_books, depth)
    return torch.gather(xs, 2, idx)


def encode(x_split: Tensor, tree: HashTree) -> Tensor:
    """Sequential tree-walk encode (Eq. 3): (B, C, I) → (B, C) int32 ids."""
    b, c_books, depth = x_split.shape
    thr = tree.thresholds[None].expand(b, -1, -1)
    node = torch.zeros((b, c_books), dtype=torch.int64, device=x_split.device)
    for level in range(depth):
        t = torch.gather(thr, 2, node[..., None])[..., 0]
        node = 2 * node + 1 + (x_split[:, :, level] >= t).to(torch.int64)
    return (node - (2**depth - 1)).to(torch.int32)


def _leaf_paths(depth: int):
    """Static (G, I) node indices + expected bits along each root→leaf path."""
    g = 2**depth
    nodes = np.zeros((g, depth), dtype=np.int64)
    bits = np.zeros((g, depth), dtype=bool)
    for leaf in range(g):
        node = 0
        for level in range(depth):
            nodes[leaf, level] = node
            bit = (leaf >> (depth - 1 - level)) & 1
            bits[leaf, level] = bool(bit)
            node = 2 * node + 1 + bit
    return nodes, bits


def encode_onehot(x_split: Tensor, tree: HashTree,
                  dtype=torch.float32) -> Tensor:
    """Parallel-comparator encode → (B, C, G) one-hot over prototypes.

    All ``2**I - 1`` node comparisons at once, then an AND along each of
    the ``2**I`` root→leaf paths (the paper's Encoder, Section V-B3).
    """
    b, c_books, depth = x_split.shape
    g = 2**depth
    dev = x_split.device
    levels = torch.as_tensor(
        np.floor(np.log2(np.arange(1, g))).astype(np.int64), device=dev)
    cmp = x_split[:, :, levels] >= tree.thresholds[None]  # (B, C, G-1)
    nodes, bits = _leaf_paths(depth)
    path = cmp[:, :, torch.as_tensor(nodes.reshape(-1), device=dev)]
    path = path.reshape(b, c_books, g, depth)
    want = torch.as_tensor(bits, device=dev)[None, None]
    return (path == want).all(dim=-1).to(dtype)


def _epilogue(acc: Tensor, lut_scale: Tensor, lut_offset: Tensor) -> Tensor:
    # two roundings, as the kernels' __fmul_rn/__fadd_rn epilogue
    return acc.to(torch.float32) * lut_scale + lut_offset


def aggregate(codes: Tensor, lut: Tensor, lut_scale: Tensor,
              lut_offset: Tensor) -> Tensor:
    """Reference LUT aggregation (Eq. 4): gather + sum.  codes (B, C) →
    (B, N) float32; int8 LUTs sum in int32."""
    c_books = lut.shape[0]
    ar = torch.arange(c_books, device=lut.device)
    gathered = lut[ar[None, :], codes.to(torch.int64)]  # (B, C, N)
    acc = gathered.to(torch.int32 if lut.dtype == torch.int8 else torch.float32)
    return _epilogue(acc.sum(dim=1, dtype=acc.dtype), lut_scale, lut_offset)


def onehot_gather_sum(lhs: Tensor, rhs: Tensor) -> Tensor:
    """``lhs (B, K) @ rhs (K, N)`` summed over ``lhs``'s nonzero entries only.

    Exact for integer operands (int32 accumulation, no float matmul that
    TF32 could round) and the natural form for one-hot left operands: each
    nonzero ``lhs[b, k]`` adds ``lhs[b, k] · rhs[k, :]`` to row ``b``.  An
    int8 ``rhs`` accumulates in int32, anything else in float32.
    """
    int_path = rhs.dtype == torch.int8
    acc_dtype = torch.int32 if int_path else torch.float32
    rows, cols = torch.nonzero(lhs, as_tuple=True)
    vals = lhs[rows, cols].to(acc_dtype)
    out = torch.zeros((lhs.shape[0], rhs.shape[1]), dtype=acc_dtype,
                      device=rhs.device)
    return out.index_add_(0, rows, vals[:, None] * rhs[cols].to(acc_dtype))


def aggregate_onehot(onehot: Tensor, lut: Tensor, lut_scale: Tensor,
                     lut_offset: Tensor) -> Tensor:
    """One-hot aggregation ``Σ_{c,g} onehot[b,c,g] · lut[c,g,n]`` — the
    (B, C·G) × (C·G, N) contraction, with the LUT in the one-hot's type."""
    lhs = onehot.reshape(onehot.shape[0], -1)
    rhs = lut.reshape(-1, lut.shape[-1]).to(lhs.dtype)
    return _epilogue(onehot_gather_sum(lhs, rhs), lut_scale, lut_offset)


def contract_onehot(onehot: Tensor, lut: Tensor, lut_scale: Tensor,
                    lut_offset: Tensor) -> Tensor:
    """dtype-dispatching one-hot contraction: int8 LUTs accumulate in int32
    (integer one-hot), float LUTs go through :func:`aggregate_onehot`."""
    if lut.dtype == torch.int8:
        lhs = onehot.to(torch.int8).reshape(onehot.shape[0], -1)
        acc = onehot_gather_sum(lhs, lut.reshape(-1, lut.shape[-1]))
        return _epilogue(acc, lut_scale, lut_offset)
    return aggregate_onehot(onehot, lut, lut_scale, lut_offset)

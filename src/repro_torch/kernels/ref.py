"""Plain PyTorch versions of the three LUT-MU kernels (the correctness
contract).

Each function is the semantic twin of one CUDA kernel, written with the
plainest torch possible (sequential tree walks, gathers, integer sums) so
that CPU tensors can take it and the card can hold each kernel against it.
Integer paths sum in int32 by gather-and-sum, never through a float matmul;
int16 tables sum in float32, as the TPU kernel and the JAX reference do.
"""
from __future__ import annotations

import torch

from repro_torch.core.maddness import onehot_gather_sum

Tensor = torch.Tensor


def encode_codes_ref(x_split: Tensor, thresholds: Tensor) -> Tensor:
    """Sequential decision-tree walk.  (B, C, I), (C, G-1) → (B, C) int32."""
    b, c, depth = x_split.shape
    thr = thresholds[None].expand(b, -1, -1)
    node = torch.zeros((b, c), dtype=torch.int64, device=x_split.device)
    for level in range(depth):
        t = torch.gather(thr, 2, node[..., None])[..., 0]
        node = 2 * node + 1 + (x_split[:, :, level] >= t).to(torch.int64)
    return (node - (2**depth - 1)).to(torch.int32)


def encode_onehot_ref(x_split: Tensor, thresholds: Tensor,
                      out_dtype=torch.float32) -> Tensor:
    """One-hot of the sequential walk.  (B, C, I) → (B, C, G)."""
    codes = encode_codes_ref(x_split, thresholds).to(torch.int64)
    g = 2 ** x_split.shape[-1]
    return torch.nn.functional.one_hot(codes, g).to(out_dtype)


def _epilogue(acc: Tensor, lut_scale: Tensor, lut_offset: Tensor) -> Tensor:
    return acc.to(torch.float32) * lut_scale + lut_offset


def lut_aggregate_ref(onehot: Tensor, lut: Tensor, lut_scale: Tensor,
                      lut_offset: Tensor) -> Tensor:
    """``onehot (B, C, G)`` × ``lut (C, G, N)`` → (B, N) float32.

    Gather-and-sum over the left operand's nonzero entries, which for a
    one-hot is the LUT-row gather.  Any left operand is taken, as the
    kernel takes one: int8 LUTs cast it to int8 and sum in int32; float
    LUTs take the LUT in the left operand's type and sum in float32.
    """
    b = onehot.shape[0]
    lhs = onehot.reshape(b, -1)
    rhs = lut.reshape(-1, lut.shape[-1])
    if lut.dtype == torch.int8:
        lhs = lhs.to(torch.int8)
    else:
        rhs = rhs.to(lhs.dtype)
    return _epilogue(onehot_gather_sum(lhs, rhs), lut_scale, lut_offset)


def fused_lutmu_ref(x_split: Tensor, thresholds: Tensor, lut: Tensor,
                    lut_scale: Tensor, lut_offset: Tensor) -> Tensor:
    """encode → aggregate, reference composition.  → (B, N) float32."""
    codes = encode_codes_ref(x_split, thresholds).to(torch.int64)
    ar = torch.arange(lut.shape[0], device=lut.device)
    gathered = lut[ar[None, :], codes]  # (B, C, N)
    acc_dtype = torch.int32 if lut.dtype == torch.int8 else torch.float32
    acc = gathered.to(acc_dtype).sum(dim=1, dtype=acc_dtype)
    return _epilogue(acc, lut_scale, lut_offset)

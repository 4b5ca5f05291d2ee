"""The MADDNESS encode and LUT gather-sum, frozen for the benchmark: plain
PyTorch, importing nothing of the program.

A LUT-MU layer maps rows ``x (B, D)`` to ``(B, N)``: ``D`` splits into
``C`` codebooks of ``d_sub`` dims; codebook ``c`` walks a balanced binary
tree of depth ``I`` (level ``l`` compares dim ``split_dims[c, l]`` of its
subspace against the node's threshold, ``x >= t`` going right; thresholds
in heap order) to a leaf ``g``; the output is ``Σ_c lut[c, g_c, :]``,
summed exactly (int8 tables in int32), then ``acc · scale + offset`` in
float32 with two roundings.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

# rows per block of the gather-sum (bounds its (rows, C, N) int8 gather)
_GATHER_BLOCK_BYTES = 512 * 2**20
INT_MM_MIN_ROWS = 16


def gather_split_values(x: Tensor, split_dims: Tensor) -> Tensor:
    """``x (B, D)`` → ``(B, C, I)``: the values the trees compare."""
    b, d = x.shape
    c, depth = split_dims.shape
    sub = x.reshape(b, c, d // c)
    idx = split_dims.to(torch.int64)[None].expand(b, c, depth)
    return torch.gather(sub, 2, idx)


def encode(xs: Tensor, thresholds: Tensor) -> Tensor:
    """Tree walk: split values ``(B, C, I)`` and heap-ordered thresholds
    ``(C, 2**I - 1)`` → leaf ids ``(B, C)`` int64."""
    b, c, depth = xs.shape
    cols = torch.arange(c, device=xs.device)[None].expand(b, c)
    node = torch.zeros((b, c), dtype=torch.int64, device=xs.device)
    for level in range(depth):
        t = thresholds[cols, node]
        node = 2 * node + 1 + (xs[:, :, level] >= t).to(torch.int64)
    return node - (2 ** depth - 1)


def lut_sums(codes: Tensor, lut: Tensor) -> Tensor:
    """Exact ``Σ_c lut[c, codes[:, c], :]`` → ``(B, N)``: int32 for an
    int8 table, float32 for a float one.

    On the card an int8 table of more than ``INT_MM_MIN_ROWS`` rows is
    summed as a one-hot ``(B, C·G)`` int8 matrix times the ``(C·G, N)``
    table with ``torch._int_mm``, whose int32 sums are exact in any order;
    otherwise (``_int_mm`` takes more than 16 rows) the selected rows are
    gathered and summed in blocks of rows."""
    b, c = codes.shape
    g, n = lut.shape[1], lut.shape[2]
    flat = codes + g * torch.arange(c, device=codes.device)[None]
    if (lut.dtype == torch.int8 and codes.is_cuda and b > INT_MM_MIN_ROWS
            and n % 8 == 0 and (c * g) % 8 == 0):
        onehot = torch.zeros((b, c * g), dtype=torch.int8, device=codes.device)
        onehot.scatter_(1, flat, 1)
        return torch._int_mm(onehot, lut.reshape(c * g, n))
    acc_dtype = torch.int32 if lut.dtype == torch.int8 else torch.float32
    rows = lut.reshape(c * g, n)
    step = max(1, _GATHER_BLOCK_BYTES // max(1, c * n * lut.element_size()))
    out = torch.empty((b, n), dtype=acc_dtype, device=lut.device)
    for s in range(0, b, step):
        out[s:s + step] = rows[flat[s:s + step]].sum(dim=1, dtype=acc_dtype)
    return out


def epilogue(acc: Tensor, scale: Tensor, offset: Tensor) -> Tensor:
    """``acc · scale + offset`` in float32, each step rounded."""
    return acc.to(torch.float32) * scale + offset


def lutmu(xs: Tensor, thresholds: Tensor, lut: Tensor, scale: Tensor,
          offset: Tensor, codes_seen=None) -> Tensor:
    """One LUT-MU call on split values ``xs (B, C, I)`` → ``(B, N)``
    float32.  ``codes_seen(codes)``, where given, sees each call's leaves."""
    codes = encode(xs.to(torch.float32), thresholds)
    if codes_seen is not None:
        codes_seen(codes)
    return epilogue(lut_sums(codes, lut), scale, offset)

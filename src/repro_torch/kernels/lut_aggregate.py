"""LUT aggregation (left operand × LUT + epilogue) on Hopper.

The port of ``repro/kernels/lut_aggregate.py::lut_aggregate_pallas``; the
kernel is ``csrc/lut_aggregate.cu``, which sums only the left operand's
nonzero entries (as the plain version does) with K split over the grid and
a fixed-order partial-sum pass.  It takes any left operand, as the TPU
kernel does.  CPU tensors take the plain version,
:func:`lut_aggregate_plain`; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lut_aggregate_ref as lut_aggregate_plain

__all__ = ["lut_aggregate", "lut_aggregate_plain", "LAUNCHES", "k_splits"]

LAUNCHES = _build.LaunchCount()

_THREADS = 64          # csrc/lut_aggregate.cu kThreads
_ROWS = 4              # csrc/lut_aggregate.cu kRows
_MIN_SPLIT_K = 256     # fewest K entries one block walks
_MAX_GRID_Z = 65535
_BLOCKS_PER_SM = 8     # K splits aim for this many blocks per SM
_F32_LHS_LUTS = (torch.float32, torch.bfloat16, torch.int16)


def block_cols(lut_dtype) -> int:
    """Output columns one block covers: 16 bytes of LUT per thread."""
    return _THREADS * (16 // torch.empty((), dtype=lut_dtype).element_size())


def k_splits(b: int, k: int, n: int, lut_dtype, sms: int):
    """K splits ``(splits, entries per split)``: enough blocks to fill
    ``sms`` SMs a few times over, without a block walking fewer than
    ``_MIN_SPLIT_K`` entries; split ``z`` sums entries
    ``[z·per, min(k, (z+1)·per))``."""
    tiles = math.ceil(n / block_cols(lut_dtype)) * math.ceil(b / _ROWS)
    want = max(1, math.ceil(_BLOCKS_PER_SM * sms / tiles))
    per = max(_MIN_SPLIT_K, math.ceil(k / want), math.ceil(k / _MAX_GRID_Z))
    per = max(1, min(per, k))
    return max(1, math.ceil(k / per)), per


def lut_aggregate(onehot: torch.Tensor, lut: torch.Tensor,
                  lut_scale: torch.Tensor, lut_offset: torch.Tensor,
                  split_k: Optional[int] = None) -> torch.Tensor:
    """``onehot (B, C, G)`` × ``lut (C, G, N)`` → (B, N) float32.

    int8 LUTs take the left operand as int8 and sum in int32; float32,
    bfloat16 or int16 LUTs take a float32 left operand and sum in float32
    (on the CPU the plain version also takes a bfloat16 one, rounding the
    LUT to it as the TPU kernel does).  With a one-hot and an int16 table
    every sum is an integer, exact while it stays within 2**24: bit-equal
    to the plain version for any table when C ≤ 512.  Only the left operand's nonzero entries
    are summed, which for a one-hot is the LUT-row gather.  ``split_k``
    sets the K entries one split walks (an autotuned plan); by default
    :func:`k_splits` picks it.
    """
    if _build.on_cpu(onehot, lut, lut_scale, lut_offset):
        return lut_aggregate_plain(onehot, lut, lut_scale, lut_offset)
    b, c, g = onehot.shape
    _build.require(lut.dim() == 3 and tuple(lut.shape[:2]) == (c, g),
                   f"lut shape {tuple(lut.shape)} != ({c}, {g}, N)")
    if lut.dtype == torch.int8:
        onehot = onehot.to(torch.int8)
    else:
        _build.require(lut.dtype in _F32_LHS_LUTS
                       and onehot.dtype == torch.float32,
                       f"unsupported operand types {onehot.dtype} × {lut.dtype}")
    _build.require_contiguous(onehot=onehot, lut=lut)
    n = lut.shape[-1]
    k = c * g
    scale_p, scale_s = _build.epilogue_args(lut_scale, n, "lut_scale")
    offset_p, offset_s = _build.epilogue_args(lut_offset, n, "lut_offset")
    out = torch.empty((b, n), dtype=torch.float32, device=lut.device)
    if out.numel() == 0:
        return out
    if split_k is None:
        splits, per = k_splits(b, k, n, lut.dtype, _build.sm_count(lut.device))
    else:
        _build.require(split_k >= 1, f"split_k must be >= 1, got {split_k}")
        per = min(split_k, k)
        splits = math.ceil(k / per)
        _build.require(splits <= _MAX_GRID_Z,
                       f"{splits} K splits exceed the grid's {_MAX_GRID_Z}")
    acc_dtype = torch.int32 if lut.dtype == torch.int8 else torch.float32
    partial = (torch.empty((splits, b, n), dtype=acc_dtype, device=lut.device)
               if splits > 1 else None)
    lib = _build.library("lut_aggregate")
    err = lib.lut_aggregate_launch(
        onehot.data_ptr(), _build.DTYPE_CODES[onehot.dtype], lut.data_ptr(),
        _build.DTYPE_CODES[lut.dtype], scale_p, scale_s, offset_p, offset_s,
        out.data_ptr(), partial.data_ptr() if partial is not None else None,
        b, k, n, per, splits, _build.stream_of(lut))
    _build.check(lib, err, "lut_aggregate")
    LAUNCHES.bump()
    return out

"""Fused LUT-MU (encode + aggregate + epilogue in one pass) on Hopper.

The port of ``repro/kernels/fused_lutmu.py::fused_lutmu_pallas``; the
kernel is ``csrc/fused_lutmu.cu`` (its header note says what bounds it and
how the design answers).  CPU tensors take the plain version,
:func:`fused_lutmu_plain`; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_lutmu_ref as fused_lutmu_plain

__all__ = ["fused_lutmu", "fused_lutmu_plain", "LAUNCHES", "block_cols",
           "num_splits"]

LAUNCHES = _build.LaunchCount()

_THREADS = 64          # csrc/fused_lutmu.cu kThreads
_ROWS = 4              # csrc/fused_lutmu.cu kRows
_MIN_SPLIT_C = 16      # fewest codebooks one block walks
_MAX_SPLIT_C = 8192    # keeps the leaf table (kRows bytes each) far below 48 KB
_BLOCKS_PER_SM = 4     # codebook splits aim for this many blocks per SM
_LUT_DTYPES = (torch.int8, torch.float32, torch.bfloat16)


def block_cols(lut_dtype) -> int:
    """Output columns one block covers: 16 bytes of LUT per thread."""
    return _THREADS * (16 // torch.empty((), dtype=lut_dtype).element_size())


def num_splits(b: int, c: int, n: int, lut_dtype, sms: int):
    """Codebook splits ``(splits, codebooks per split)``: enough blocks to
    fill ``sms`` SMs a few times over, without a block walking fewer than
    ``_MIN_SPLIT_C`` codebooks."""
    tiles = math.ceil(n / block_cols(lut_dtype)) * math.ceil(b / _ROWS)
    want = max(1, math.ceil(_BLOCKS_PER_SM * sms / tiles))
    per = max(_MIN_SPLIT_C, math.ceil(c / want), math.ceil(c / 65535))
    per = min(per, _MAX_SPLIT_C, c)
    return math.ceil(c / per), per


def fused_lutmu(x_split: torch.Tensor, thresholds: torch.Tensor,
                lut: torch.Tensor, lut_scale: torch.Tensor,
                lut_offset: torch.Tensor) -> torch.Tensor:
    """Split values → approximate matmul output.

    Args:
      x_split: (B, C, I) float32 gathered split-dim values.
      thresholds: (C, 2**I - 1) float32, heap order.
      lut: (C, 2**I, N) int8 (int32 sums) or float32/bfloat16 (float32 sums).
      lut_scale / lut_offset: float32 epilogue, () or (N,).

    Returns:
      (B, N) float32.
    """
    if _build.on_cpu(x_split, thresholds, lut, lut_scale, lut_offset):
        return fused_lutmu_plain(x_split, thresholds, lut, lut_scale,
                                 lut_offset)
    b, c, depth = x_split.shape
    g = 2**depth
    _build.require(1 <= depth <= 8, f"tree depth must be in [1, 8], got {depth}")
    _build.require(x_split.dtype == torch.float32 and
                   thresholds.dtype == torch.float32,
                   "x_split and thresholds must be float32")
    _build.require(lut.dtype in _LUT_DTYPES,
                   f"lut dtype must be one of {_LUT_DTYPES}, got {lut.dtype}")
    _build.require(tuple(thresholds.shape) == (c, g - 1),
                   f"thresholds shape {tuple(thresholds.shape)} != {(c, g - 1)}")
    _build.require(lut.dim() == 3 and tuple(lut.shape[:2]) == (c, g),
                   f"lut shape {tuple(lut.shape)} != ({c}, {g}, N)")
    _build.require_contiguous(x_split=x_split, thresholds=thresholds, lut=lut)
    n = lut.shape[-1]
    scale_p, scale_s = _build.epilogue_args(lut_scale, n, "lut_scale")
    offset_p, offset_s = _build.epilogue_args(lut_offset, n, "lut_offset")
    out = torch.empty((b, n), dtype=torch.float32, device=lut.device)
    if out.numel() == 0:
        return out
    splits, per = num_splits(b, c, n, lut.dtype, _build.sm_count(lut.device))
    acc_dtype = torch.int32 if lut.dtype == torch.int8 else torch.float32
    partial = (torch.empty((splits, b, n), dtype=acc_dtype, device=lut.device)
               if splits > 1 else None)
    lib = _build.library("fused_lutmu")
    err = lib.fused_lutmu_launch(
        x_split.data_ptr(), thresholds.data_ptr(), lut.data_ptr(),
        _build.DTYPE_CODES[lut.dtype], scale_p, scale_s, offset_p, offset_s,
        out.data_ptr(), partial.data_ptr() if partial is not None else None,
        b, c, n, depth, per, splits, _build.stream_of(lut))
    _build.check(lib, err, "fused_lutmu")
    LAUNCHES.bump()
    return out

"""MADDNESS encode to a one-hot on Hopper.

The port of ``repro/kernels/maddness_encode.py::encode_onehot_pallas``; the
kernel is ``csrc/maddness_encode.cu``.  CPU tensors take the plain version,
:func:`encode_onehot_plain`; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import encode_onehot_ref as encode_onehot_plain

__all__ = ["encode_onehot", "encode_onehot_plain", "LAUNCHES"]

LAUNCHES = _build.LaunchCount()

_OUT_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def encode_onehot(x_split: torch.Tensor, thresholds: torch.Tensor, *,
                  out_dtype=torch.float32) -> torch.Tensor:
    """(B, C, I) float32, (C, 2**I - 1) float32 → one-hot (B, C, 2**I)."""
    if _build.on_cpu(x_split, thresholds):
        return encode_onehot_plain(x_split, thresholds, out_dtype)
    b, c, depth = x_split.shape
    g = 2**depth
    _build.require(1 <= depth <= 16, f"tree depth must be in [1, 16], got {depth}")
    _build.require(x_split.dtype == torch.float32 and
                   thresholds.dtype == torch.float32,
                   "x_split and thresholds must be float32")
    _build.require(out_dtype in _OUT_DTYPES,
                   f"out_dtype must be one of {_OUT_DTYPES}, got {out_dtype}")
    _build.require(tuple(thresholds.shape) == (c, g - 1),
                   f"thresholds shape {tuple(thresholds.shape)} != {(c, g - 1)}")
    _build.require_contiguous(x_split=x_split, thresholds=thresholds)
    out = torch.empty((b, c, g), dtype=out_dtype, device=x_split.device)
    if out.numel() == 0:
        return out
    lib = _build.library("maddness_encode")
    err = lib.encode_onehot_launch(
        x_split.data_ptr(), thresholds.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[out_dtype], b, c, depth, _build.stream_of(x_split))
    _build.check(lib, err, "encode_onehot")
    LAUNCHES.bump()
    return out

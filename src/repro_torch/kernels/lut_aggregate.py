"""LUT aggregation (left operand × LUT + epilogue) on Hopper.

The port of ``repro/kernels/lut_aggregate.py::lut_aggregate_pallas``; the
kernel is ``csrc/lut_aggregate.cu``, a tiled shared-memory product that
takes any left operand, as the TPU kernel does.  CPU tensors take the plain
version, :func:`lut_aggregate_plain`; CUDA tensors launch the kernel or
raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lut_aggregate_ref as lut_aggregate_plain

__all__ = ["lut_aggregate", "lut_aggregate_plain", "LAUNCHES"]

LAUNCHES = _build.LaunchCount()

_FLOAT_LUTS = (torch.float32, torch.bfloat16)


def lut_aggregate(onehot: torch.Tensor, lut: torch.Tensor,
                  lut_scale: torch.Tensor,
                  lut_offset: torch.Tensor) -> torch.Tensor:
    """``onehot (B, C, G)`` × ``lut (C, G, N)`` → (B, N) float32.

    int8 LUTs take the left operand as int8 and sum in int32; float32 or
    bfloat16 LUTs take a float32 left operand and sum in float32 (on the
    CPU the plain version also takes a bfloat16 one, rounding the LUT to
    it as the TPU kernel does).
    """
    if _build.on_cpu(onehot, lut, lut_scale, lut_offset):
        return lut_aggregate_plain(onehot, lut, lut_scale, lut_offset)
    b, c, g = onehot.shape
    _build.require(lut.dim() == 3 and tuple(lut.shape[:2]) == (c, g),
                   f"lut shape {tuple(lut.shape)} != ({c}, {g}, N)")
    if lut.dtype == torch.int8:
        onehot = onehot.to(torch.int8)
    else:
        _build.require(lut.dtype in _FLOAT_LUTS and onehot.dtype == torch.float32,
                       f"unsupported operand types {onehot.dtype} × {lut.dtype}")
    _build.require_contiguous(onehot=onehot, lut=lut)
    n = lut.shape[-1]
    k = c * g
    scale_p, scale_s = _build.epilogue_args(lut_scale, n, "lut_scale")
    offset_p, offset_s = _build.epilogue_args(lut_offset, n, "lut_offset")
    out = torch.empty((b, n), dtype=torch.float32, device=lut.device)
    if out.numel() == 0:
        return out
    lib = _build.library("lut_aggregate")
    err = lib.lut_aggregate_launch(
        onehot.data_ptr(), _build.DTYPE_CODES[onehot.dtype], lut.data_ptr(),
        _build.DTYPE_CODES[lut.dtype], scale_p, scale_s, offset_p, offset_s,
        out.data_ptr(), b, k, n, _build.stream_of(lut))
    _build.check(lib, err, "lut_aggregate")
    LAUNCHES.bump()
    return out

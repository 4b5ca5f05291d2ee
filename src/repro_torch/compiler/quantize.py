"""LUT resolution configs and int4 packing (the runtime half of
``repro.compiler.quantize``).

The paper measures its resource savings across LUT *resolution configs*,
the bit width of the stored LUT entries:

  ============  ==========  ================  ==========================
  config        entry bits  runtime dtype     storage
  ============  ==========  ================  ==========================
  ``float32``   32          float32           as-is (reference)
  ``int16``     16          int16             int16 tensor
  ``int8``      8           int8              int8 tensor
  ``int4``      4           int8 (unpacked)   two entries per uint8 byte
  ============  ==========  ================  ==========================

Every config runs through the unchanged ``lutmu_matmul`` aggregation: int8
sums in int32, int16 sums in float32 (exact integers) and int4 is unpacked
to int8 when an artifact is read.  The fitting functions
(``quantize_lut``, ``resource_report``) come with the offline compiler.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ResolutionConfig:
    """One LUT precision setting."""

    name: str
    bits: int           # quantised entry width (32 = float passthrough)
    storage_bits: int   # bits actually stored per entry (int4 packs 2/byte)

    @property
    def is_float(self) -> bool:
        return self.bits >= 32

    @property
    def runtime_dtype(self) -> torch.dtype:
        """dtype the online engine sees (int4 unpacks to int8)."""
        if self.is_float:
            return torch.float32
        return torch.int16 if self.bits == 16 else torch.int8


RESOLUTIONS: Dict[str, ResolutionConfig] = {
    "float32": ResolutionConfig("float32", 32, 32),
    "int16": ResolutionConfig("int16", 16, 16),
    "int8": ResolutionConfig("int8", 8, 8),
    "int4": ResolutionConfig("int4", 4, 4),
}


def get_resolution(name: str) -> ResolutionConfig:
    try:
        return RESOLUTIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown resolution {name!r}; choose from {sorted(RESOLUTIONS)}")


def pack_int4(q: np.ndarray) -> np.ndarray:
    """(C, G, N) int8 entries in [-8, 7] → (C, G, ceil(N/2)) uint8, two
    nibbles per byte, offset-binary (+8), low nibble = even column; an odd
    column count is padded with a zero entry."""
    if q.dtype != np.int8:
        raise ValueError(f"int4 packing expects int8 codes, got {q.dtype}")
    c, g, n = q.shape
    if n % 2:
        q = np.concatenate([q, np.zeros((c, g, 1), np.int8)], axis=-1)
    u = (q.astype(np.int16) + 8).astype(np.uint8)  # [0, 15]
    return (u[..., 0::2] | (u[..., 1::2] << 4)).astype(np.uint8)


def unpack_int4(packed: np.ndarray, n_cols: int) -> np.ndarray:
    """Inverse of :func:`pack_int4` → (C, G, n_cols) int8 in [-8, 7]."""
    lo = (packed & 0x0F).astype(np.int16) - 8
    hi = ((packed >> 4) & 0x0F).astype(np.int16) - 8
    c, g, m = packed.shape
    out = np.empty((c, g, 2 * m), np.int8)
    out[..., 0::2] = lo
    out[..., 1::2] = hi
    return out[..., :n_cols]

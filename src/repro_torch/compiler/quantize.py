"""LUT resolution configs, the quantiser, int4 packing and the resource
report, as in ``repro.compiler.quantize``.

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
to int8 when an artifact is read.

Quantisation scheme: per-(codebook, column) offsets — the min over the
``G`` prototypes — are absorbed into one per-column offset by summing over
codebooks, and a per-column scale shared across codebooks covers the
widest codebook's range, so the dequant stays the engine's one epilogue
``out[n] = (Σ_c q[c, g_c, n]) · scale[n] + offset[n]``.  :func:`quantize_lut`
is numpy in float64, the JAX package's arithmetic, so both write the same
codes from the same float table.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

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


def quantize_lut(lut: np.ndarray, offset: Optional[np.ndarray], bits: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantise a float (C, G, N) LUT to ``bits``-wide integer entries.

    Args:
      lut: float32 (C, G, N), already pruned to its surviving columns (the
        scales are then computed on exactly the entries that ship).
      offset: existing per-column float offset (bias), folded into the new
        dequant offset; None means zero.

    Returns:
      (q, scale, offset): integer LUT (int8 for bits ≤ 8, else int16) and
      per-column (N,) float32 scale and offset with
      ``out ≈ (Σ_c q[c, g_c]) · scale + offset``.
    """
    if bits not in (4, 8, 16):
        raise ValueError(f"bits must be 4, 8 or 16, got {bits}")
    lut = np.asarray(lut, np.float64)
    c_books = lut.shape[0]
    levels = 2**bits
    half = levels // 2
    mins = lut.min(axis=1)                      # (C, N) per-codebook offsets
    rng = (lut.max(axis=1) - mins).max(axis=0)  # (N,) widest codebook range
    scale = np.maximum(rng, 1e-8) / (levels - 1)
    q = np.round((lut - mins[:, None, :]) / scale) - half
    q = np.clip(q, -half, half - 1)
    q = q.astype(np.int8 if bits <= 8 else np.int16)
    new_offset = mins.sum(axis=0) + half * c_books * scale
    if offset is not None:
        new_offset = new_offset + np.asarray(offset, np.float64)
    return q, scale.astype(np.float32), new_offset.astype(np.float32)


def dequantize_lut(q: np.ndarray) -> np.ndarray:
    """Integer entries back to float32 *codes* (scale/offset not applied —
    the engine's epilogue owns those).  Identity for float LUTs."""
    return np.asarray(q, np.float32)


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


def lut_storage_bits(num_codebooks: int, depth: int, cols: int,
                     resolution: ResolutionConfig) -> int:
    """Stored LUT size in bits for one layer at one resolution config."""
    return num_codebooks * 2**depth * cols * resolution.storage_bits


def resource_report(
    layer_shapes: Sequence[Tuple[int, int, int, int]],
    resolutions: Sequence[str] = ("float32", "int16", "int8", "int4"),
) -> dict:
    """The paper's resource-savings table across resolution configs.

    Args:
      layer_shapes: per layer ``(num_codebooks, depth, pruned_cols,
        full_cols)`` — pruned_cols is what ships.

    Returns:
      dict with per-config total LUT bytes (pruned and unpruned) and the
      savings ratios against the float32-unpruned baseline and against the
      same config unpruned.
    """
    report: dict = {"layers": [], "configs": {}}
    for c, depth, pruned_cols, full_cols in layer_shapes:
        report["layers"].append({
            "num_codebooks": c, "depth": depth,
            "pruned_cols": pruned_cols, "full_cols": full_cols,
        })
    baseline_bits = sum(
        lut_storage_bits(c, d, full, RESOLUTIONS["float32"])
        for c, d, _, full in layer_shapes)
    for name in resolutions:
        res = get_resolution(name)
        pruned_bits = sum(lut_storage_bits(c, d, pruned, res)
                          for c, d, pruned, _ in layer_shapes)
        unpruned_bits = sum(lut_storage_bits(c, d, full, res)
                            for c, d, _, full in layer_shapes)
        report["configs"][name] = {
            "pruned_lut_bytes": pruned_bits // 8,
            "unpruned_lut_bytes": unpruned_bits // 8,
            "savings_vs_float32_unpruned": round(
                baseline_bits / max(pruned_bits, 1), 3),
            "savings_vs_same_config_unpruned": round(
                unpruned_bits / max(pruned_bits, 1), 3),
        }
    return report

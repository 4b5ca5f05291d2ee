"""MADDNESS encode to a one-hot on Hopper.

The port of ``repro/kernels/maddness_encode.py::encode_onehot_pallas``; the
kernel is ``csrc/maddness_encode.cu`` (its header note says what bounds it
and how the design answers).  CPU tensors take the plain version,
:func:`encode_onehot_plain`; CUDA tensors launch the kernel or raise.

:func:`plan` sizes a launch: tiles of ``b_t`` rows × ``c_t`` codebooks,
one block each, and whether the tile's thresholds are staged in shared
memory.  It is pure Python, so the CPU tests check it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import encode_onehot_ref as encode_onehot_plain

__all__ = ["encode_onehot", "encode_onehot_plain", "LAUNCHES", "Plan", "plan",
           "sized", "smem_bytes", "launch"]

LAUNCHES = _build.LaunchCount()

THREADS = 256              # csrc/maddness_encode.cu kThreads
MAX_DEPTH = 16
ROWS = 32                  # most rows of a tile
PAIRS = THREADS            # most (row, codebook) pairs of a tile: one a thread
MIN_PAIRS = 128            # fewest pairs the fill rule leaves a tile
OUT_BYTES = 32 * 1024      # one-hot bytes a tile aims to write
THR_BUDGET = 96 * 1024     # most bytes of a tile's staged thresholds; a
                           # depth whose one codebook does not fit (15, 16)
                           # reads them from device memory
# the most shared memory any plan takes: the thresholds, ≤ PAIRS·16 split
# values plus ROWS runs' padding, and PAIRS leaves
SMEM_BUDGET = THR_BUDGET + 4 * (PAIRS * MAX_DEPTH + 6 * ROWS) + 4 * PAIRS
_OUT_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def _run_floats(n: int) -> int:
    """Shared-memory floats of a staged run of n floats (its 16-byte phase
    in front, rounded up to 16 bytes)."""
    return (n + 6) & ~3


def smem_bytes(b_t: int, c_t: int, depth: int, thr_smem: bool) -> int:
    """Shared memory of one block (``csrc/maddness_encode.cu`` ``Layout``):
    the staged thresholds, ``b_t`` runs of split values, the leaves."""
    thr = _run_floats(c_t * (2**depth - 1)) if thr_smem else 0
    return 4 * (thr + b_t * _run_floats(c_t * depth) + b_t * c_t)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: a block per tile of ``b_t`` rows × ``c_t`` codebooks,
    ``grid`` blocks (codebook tiles of a row tile next to each other); the
    tile's thresholds in shared memory when ``thr_smem``, else read from
    device memory; ``smem`` bytes of shared memory per block."""
    c_t: int
    b_t: int
    thr_smem: bool
    smem: int
    grid: int


def _thr_cap(depth: int) -> int:
    """Most codebooks whose staged thresholds fit ``THR_BUDGET`` (0: not
    one)."""
    return (THR_BUDGET // 4 - 6) // (2**depth - 1)


def sized(b: int, c: int, depth: int, b_t: int, c_t: int,
          thr_smem: Optional[bool] = None) -> Plan:
    """The plan of given tiles (``thr_smem`` by default wherever the
    thresholds fit)."""
    if thr_smem is None:
        thr_smem = c_t <= _thr_cap(depth)
    return Plan(c_t, b_t, thr_smem, smem_bytes(b_t, c_t, depth, thr_smem),
                math.ceil(b / b_t) * math.ceil(c / c_t))


def _tile(b: int, c: int, depth: int, pairs: int):
    b_t = min(b, ROWS, pairs)
    c_t = max(1, min(c, pairs // b_t))
    cap = _thr_cap(depth)
    return b_t, (min(c_t, cap) if cap >= 1 else c_t)


def plan(b: int, c: int, depth: int, out_itemsize: int, sms: int) -> Plan:
    """The launch for ``b`` rows, ``c`` codebooks, a tree of ``depth``
    levels and ``out_itemsize``-byte one-hot entries on ``sms`` SMs.

    A tile holds up to ``PAIRS`` (row, codebook) pairs and writes about
    ``OUT_BYTES`` of one-hot; while the grid has fewer blocks than SMs the
    tiles halve, down to ``MIN_PAIRS`` pairs, so a prefill chunk fills the
    card while a decode call stays a few blocks (it is latency-bound at
    any grid).  Rows go up to ``ROWS`` a tile, so a block stages its
    codebooks' thresholds once for many rows; ``c_t`` shrinks until they
    fit ``THR_BUDGET``, and depths where one codebook does not read them
    from device memory."""
    g = 2**depth
    pairs = max(1, min(PAIRS, OUT_BYTES // (g * out_itemsize)))
    while pairs > MIN_PAIRS:
        b_t, c_t = _tile(b, c, depth, pairs)
        if math.ceil(b / b_t) * math.ceil(c / c_t) >= sms:
            break
        pairs //= 2
    b_t, c_t = _tile(b, c, depth, pairs)
    return sized(b, c, depth, b_t, c_t)


@functools.lru_cache(maxsize=None)
def _plan_for(b: int, c: int, depth: int, itemsize: int,
              device_index: int) -> Plan:
    return plan(b, c, depth, itemsize,
                _build.sm_count(torch.device("cuda", device_index)))


def encode_onehot(x_split: torch.Tensor, thresholds: torch.Tensor, *,
                  out_dtype=torch.float32,
                  launch_plan: Optional[Plan] = None) -> torch.Tensor:
    """(B, C, I) float32, (C, 2**I - 1) float32 → one-hot (B, C, 2**I);
    ``launch_plan`` as :func:`launch` takes it (the plain version ignores
    it)."""
    if _build.on_cpu(x_split, thresholds):
        return encode_onehot_plain(x_split, thresholds, out_dtype)
    return launch(x_split, thresholds, out_dtype, launch_plan)


def launch(x_split: torch.Tensor, thresholds: torch.Tensor,
           out_dtype=torch.float32,
           launch_plan: Optional[Plan] = None) -> torch.Tensor:
    """The kernel on CUDA tensors, with :func:`plan`'s launch unless
    ``launch_plan`` names another (the card tests force other tiles and
    the device-memory threshold instance)."""
    b, c, depth = x_split.shape
    g = 2**depth
    _build.require(1 <= depth <= MAX_DEPTH,
                   f"tree depth must be in [1, {MAX_DEPTH}], got {depth}")
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
    p = launch_plan or _plan_for(b, c, depth, out.element_size(),
                                 x_split.device.index or 0)
    lib = _build.library("maddness_encode")
    err = lib.encode_onehot_launch(
        x_split.data_ptr(), thresholds.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[out_dtype], b, c, depth, p.b_t, p.c_t,
        int(p.thr_smem), p.smem, _build.stream_of(x_split))
    _build.check(lib, err, "encode_onehot")
    LAUNCHES.bump()
    return out

"""Fused LUT-MU (encode + aggregate + epilogue in one pass) on Hopper.

The port of ``repro/kernels/fused_lutmu.py::fused_lutmu_pallas``; the
kernel is ``csrc/fused_lutmu.cu`` (its header note says what bounds it and
how the design answers).  CPU tensors take the plain version,
:func:`fused_lutmu_plain`; CUDA tensors launch the kernel or raise.

:func:`plan` sizes a launch: the thread-block cluster that splits the
codebooks, the ring stage and whether the slice's thresholds go to shared
memory.  It is pure Python, so the CPU tests check it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_lutmu_ref as fused_lutmu_plain

__all__ = ["fused_lutmu", "fused_lutmu_plain", "LAUNCHES", "Plan", "plan",
           "sized", "smem_bytes", "tile_bytes", "launch", "check_plan"]

LAUNCHES = _build.LaunchCount()

GROUP_ROWS = 32            # csrc/fused_lutmu.cu kGroupRows: rows of a block
MAX_CLUSTER = 16           # csrc/fused_lutmu.cu kMaxCluster (non-portable
                           # above 8)
MAX_SMEM = 232448          # csrc/fused_lutmu.cu kMaxSmem: 227 KB per block
_CONSUMERS = 256           # csrc/fused_lutmu.cu kConsumers
_STAGES = 4                # csrc/fused_lutmu.cu kStages
_TAB_SLOTS = 2 * _STAGES   # csrc/fused_lutmu.cu kTabSlots
_BARS = 2 * _STAGES + _TAB_SLOTS  # csrc/fused_lutmu.cu kBars
_STAGE_BYTES = 16 * 1024   # LUT bytes of a full ring stage
_THR_BYTES = 48 * 1024     # most bytes of a slice's thresholds kept in
                           # shared memory (else read from device memory)
_BLOCKS_PER_SM = 1.6       # blocks of one wave the cluster size aims for:
                           # the fastest of every (tile, cluster) plan in
                           # each kernel-phase case of chip_smoke.py had
                           # 200-204 blocks on the 132-SM H100
_LUT_DTYPES = (torch.int8, torch.int16, torch.float32, torch.bfloat16)


def tile_bytes(itemsize: int) -> int:
    """Bytes of a block's N-tile (csrc/fused_lutmu.cu kTileBytes): 256 for
    int8 tables, 512 for 2- and 4-byte entries."""
    return 256 if itemsize == 1 else 512


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: N-tiles of ``tile_bytes``; clusters of ``cluster``
    blocks, block ``k`` of which sums codebooks ``[k·per, (k+1)·per)``;
    ``k_stage`` codebooks per ring stage; the slice's thresholds in shared
    memory when ``thr_smem``; ``smem`` bytes of shared memory per block."""
    tile_bytes: int
    cluster: int
    per: int
    k_stage: int
    thr_smem: bool
    smem: int


def _rows(b: int, depth: int):
    """(rows_cap, rows_p2, max_seg): a block's table rows, the encode's
    lanes per codebook, the most distinct leaves of a codebook."""
    rows_cap = min(b, GROUP_ROWS)
    return rows_cap, 1 << (rows_cap - 1).bit_length(), min(rows_cap, 2**depth)


def smem_bytes(b: int, depth: int, itemsize: int, per: int, k_stage: int,
               thr_smem: bool) -> int:
    """Shared memory of one block (``csrc/fused_lutmu.cu`` ``Plan``): the
    mbarriers, the leaf tables of ``_TAB_SLOTS`` stages, the slice's
    thresholds, then the ring, which the partial sums of every phase
    reuse."""
    def a16(v):
        return -(-v // 16) * 16

    tb = tile_bytes(itemsize)
    rows_cap, rows_p2, max_seg = _rows(b, depth)
    cells = _TAB_SLOTS * k_stage
    tables = (a16(_BARS * 8) + a16(cells) + a16(cells * max_seg)
              + a16(cells * rows_cap))
    thr = a16(per * (2**depth - 1) * 4) if thr_smem else 0
    lanes = _CONSUMERS // (tb // 16)
    phases = lanes // min(lanes, rows_p2)
    ring = _STAGES * k_stage * max_seg * tb
    part = phases * rows_cap * (tb // itemsize) * 4
    return tables + thr + max(ring, part)


def sized(b: int, c: int, depth: int, itemsize: int, cluster: int) -> Plan:
    """The plan of one cluster size: the codebooks split evenly over the
    cluster, ring stages of at most ``_STAGE_BYTES`` of distinct segments
    and one (codebook, row) per consumer thread to encode."""
    tb = tile_bytes(itemsize)
    _, rows_p2, max_seg = _rows(b, depth)
    per = max(1, math.ceil(c / cluster))
    k_stage = max(1, min(per, _STAGE_BYTES // tb // max_seg,
                         _CONSUMERS // rows_p2))
    thr_smem = per * (2**depth - 1) * 4 <= _THR_BYTES
    return Plan(tb, cluster, per, k_stage, thr_smem,
                smem_bytes(b, depth, itemsize, per, k_stage, thr_smem))


def plan(b: int, c: int, n: int, depth: int, itemsize: int, sms: int,
         max_clusters: Optional[Callable[[Plan], int]] = None) -> Plan:
    """The launch for ``b`` rows, ``c`` codebooks, ``n`` columns of
    ``itemsize``-byte LUT entries on ``sms`` SMs: the largest cluster that
    keeps the grid near ``_BLOCKS_PER_SM`` blocks per SM, gives every
    block codebooks, and runs in one wave.  ``max_clusters(plan)`` is the
    number of clusters the card runs at once (the kernel's occupancy
    query); without it, shared memory alone decides (two blocks per SM at
    most)."""
    tiles = max(1, math.ceil(n * itemsize / tile_bytes(itemsize)))
    clusters = tiles * max(1, math.ceil(b / GROUP_ROWS))
    want = max(1, min(MAX_CLUSTER, c, int(_BLOCKS_PER_SM * sms // clusters)))
    for cluster in range(want, 1, -1):
        p = sized(b, c, depth, itemsize, cluster)
        if math.ceil(c / p.per) < cluster:
            continue  # a block of the cluster would have no codebook
        if max_clusters is not None:
            resident = max_clusters(p)
        else:
            resident = sms * min(2, MAX_SMEM // (p.smem + 1024)) // cluster
        if resident >= clusters:
            return p
    return sized(b, c, depth, itemsize, 1)


@functools.lru_cache(maxsize=None)
def _max_clusters(dtype_code: int, b: int, depth: int, p: Plan) -> int:
    lib = _build.library("fused_lutmu")
    n = lib.fused_lutmu_max_clusters(dtype_code, b, depth, p.tile_bytes,
                                     p.cluster, p.per, p.k_stage,
                                     int(p.thr_smem))
    if n < 0:
        _build.check(lib, -n, "fused_lutmu occupancy query")
    return n


def check_plan(b: int, depth: int, lut_dtype, p: Plan) -> None:
    """Raise unless the card runs at least one cluster of plan ``p`` (the
    kernel's occupancy query; shared memory within ``MAX_SMEM``)."""
    _build.require(p.smem <= MAX_SMEM and p.cluster <= MAX_CLUSTER,
                   f"fused_lutmu plan {p} exceeds {MAX_SMEM} bytes of shared "
                   f"memory or {MAX_CLUSTER} blocks per cluster")
    n = _max_clusters(_build.DTYPE_CODES[lut_dtype], b, depth, p)
    _build.require(n >= 1, f"fused_lutmu plan {p} fails the occupancy check "
                   f"at B={b}, depth {depth}: no cluster fits an SM group")


@functools.lru_cache(maxsize=None)
def _plan_for(b: int, c: int, n: int, depth: int, lut_dtype, device_index: int
              ) -> Plan:
    code = _build.DTYPE_CODES[lut_dtype]
    itemsize = torch.empty((), dtype=lut_dtype).element_size()
    return plan(b, c, n, depth, itemsize,
                _build.sm_count(torch.device("cuda", device_index)),
                lambda p: _max_clusters(code, b, depth, p))


def fused_lutmu(x_split: torch.Tensor, thresholds: torch.Tensor,
                lut: torch.Tensor, lut_scale: torch.Tensor,
                lut_offset: torch.Tensor,
                launch_plan: Optional[Plan] = None) -> torch.Tensor:
    """Split values → approximate matmul output.

    Args:
      x_split: (B, C, I) float32 gathered split-dim values.
      thresholds: (C, 2**I - 1) float32, heap order.
      lut: (C, 2**I, N) int8 or int16 (int32 sums), or float32/bfloat16
        (float32 sums).  The plain version sums int16 entries in float32,
        which is exact, and so bit-equal to the kernel, while every sum
        stays within 2**24: for any table when C ≤ 512.
      lut_scale / lut_offset: float32 epilogue, () or (N,).
      launch_plan: a launch other than :func:`plan`'s (an autotuned one,
        ``kernels/autotune.py``); the plain version ignores it.

    Returns:
      (B, N) float32.
    """
    if _build.on_cpu(x_split, thresholds, lut, lut_scale, lut_offset):
        return fused_lutmu_plain(x_split, thresholds, lut, lut_scale,
                                 lut_offset)
    return launch(x_split, thresholds, lut, lut_scale, lut_offset,
                  launch_plan)


def launch(x_split: torch.Tensor, thresholds: torch.Tensor, lut: torch.Tensor,
           lut_scale: torch.Tensor, lut_offset: torch.Tensor,
           launch_plan: Optional[Plan] = None) -> torch.Tensor:
    """The kernel on CUDA tensors, with :func:`plan`'s launch unless
    ``launch_plan`` names another (the card tests force every tile width
    and cluster size; the autotuner measures cluster sizes).  A named plan
    that fails :func:`check_plan` raises."""
    b, c, depth = x_split.shape
    g = 2**depth
    _build.require(1 <= depth <= 8, f"tree depth must be in [1, 8], got {depth}")
    _build.require(x_split.dtype == torch.float32 and
                   thresholds.dtype == torch.float32,
                   "x_split and thresholds must be float32")
    _build.require(lut.dtype in _LUT_DTYPES,
                   f"lut dtype must be one of {_LUT_DTYPES}, got {lut.dtype}")
    _build.require(lut.dtype != torch.int16 or c <= 2**16,
                   f"int16 tables of {c} > 65536 codebooks overflow the "
                   "kernel's int32 sums")
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
    if launch_plan is not None:
        check_plan(b, depth, lut.dtype, launch_plan)
    p = launch_plan or _plan_for(b, c, n, depth, lut.dtype,
                                 lut.device.index or 0)
    # clusters × row groups × N-tiles share grid.x (csrc/fused_lutmu.cu)
    blocks = (math.ceil(n * lut.element_size() / p.tile_bytes) * p.cluster *
              math.ceil(b / GROUP_ROWS))
    _build.require(b < 2**31 and blocks < 2**31,
                   f"{b} rows exceed the kernel's int32 indices and grid")
    lib = _build.library("fused_lutmu")
    err = lib.fused_lutmu_launch(
        x_split.data_ptr(), thresholds.data_ptr(), lut.data_ptr(),
        _build.DTYPE_CODES[lut.dtype], scale_p, scale_s, offset_p, offset_s,
        out.data_ptr(), b, c, n, depth, p.tile_bytes, p.cluster, p.per,
        p.k_stage, int(p.thr_smem), _build.stream_of(lut))
    _build.check(lib, err, "fused_lutmu")
    LAUNCHES.bump()
    return out

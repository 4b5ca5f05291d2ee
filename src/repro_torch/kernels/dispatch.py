"""Unified LUT-MU execution engine: one entry point, three backends.

``lutmu_matmul(x, params, backend="auto")`` is the single call site the
models use, as in ``repro.kernels.dispatch``.  It normalises the input form,
picks a backend per shape/dtype/device and runs:

  * ``"ref"``     — plain PyTorch: parallel-comparator one-hot encode + an
    integer-exact contraction (``core.maddness``).  The path CPU tensors
    take under ``auto``; on a CUDA tensor it runs only when asked for by
    name.
  * ``"unfused"`` — two CUDA kernels: ``maddness_encode`` then
    ``lut_aggregate``; the one-hot round-trips through device memory.
  * ``"fused"``   — the single-pass CUDA kernel (``fused_lutmu``).

On CPU tensors the kernel wrappers run their plain versions, so every
backend executes in the CPU tests.  ``REPRO_LUTMU_BACKEND`` overrides
``"auto"``.  On CUDA tensors each launch follows a plan resolved through
``kernels.autotune`` (an explicit ``tiles``, else the cache's entry for the
shape, else the wrappers' own pick), as the JAX dispatch resolves tiles.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Optional

import torch

from repro_torch.core.maddness import (HashTree, MaddnessParams,
                                       contract_onehot, encode_onehot,
                                       gather_split_values)
from repro_torch.core.pruning import PruningPlan, pruned_to_split_values
from repro_torch.distributed.sharding import MeshComm, mesh_shape
from repro_torch.kernels import _build
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import fused_lutmu as FL
from repro_torch.kernels.lut_aggregate import lut_aggregate
from repro_torch.kernels.maddness_encode import encode_onehot as encode_onehot_cuda

Tensor = torch.Tensor

BACKENDS = ("ref", "unfused", "fused")
INPUT_KINDS = ("full", "split", "package")

# Calls of the ``ref`` backend on CUDA tensors (only ever by name); the
# chip smoke run asserts the main path made none.
REF_ON_CUDA = _build.LaunchCount()

# Optional observability hook: called with the call's static metadata (ints
# and strings only) after backend selection.  None costs one check a call.
# It is Python, so inside a serving step's captured program
# (serving/programs.py) it runs at warm-up and capture only, never at replay.
_PROFILE_HOOK = None


def set_profile_hook(hook) -> None:
    """Install (or clear, with ``None``) the dispatch-metadata hook."""
    global _PROFILE_HOOK
    _PROFILE_HOOK = hook


@contextlib.contextmanager
def profile_hook_paused():
    """Hold the dispatch hook off for a block (a step program's calls that
    build nothing: its warm-up, and its repeat calls on the CPU)."""
    global _PROFILE_HOOK
    hook, _PROFILE_HOOK = _PROFILE_HOOK, None
    try:
        yield
    finally:
        _PROFILE_HOOK = hook


# N-tile count past which the fused kernel's per-N-tile encode recompute
# outweighs the unfused path's one-hot round trip, for deep trees (G ≥ 64)
# with float LUTs (the JAX dispatch's rule 4), in fixed tiles of 256
# columns: the rule does not move with the kernel's own tiling.
_UNFUSED_N_TILES = 8
_UNFUSED_TILE_COLS = 256
_UNFUSED_MIN_G = 64


def params_from_arrays(split_dims: Tensor, thresholds: Tensor, lut: Tensor,
                       lut_scale: Tensor, lut_offset: Tensor) -> MaddnessParams:
    """Bundle raw tensors (e.g. a serving param dict) into
    ``MaddnessParams``; prototypes are only needed offline."""
    return MaddnessParams(HashTree(split_dims, thresholds), None, lut,
                          lut_scale, lut_offset)


def select_backend(b: int, c: int, n: int, depth: int,
                   lut_dtype=torch.float32, device_type: str = "cuda") -> str:
    """Shape/dtype/device → backend name (the ``"auto"`` policy).

      1. tensors on the CPU → ``ref`` (the kernels' plain versions exist
         for correctness, never for speed);
      2. int8 LUTs → ``fused``: int32 sums of gathered LUT rows, no one-hot;
      3. many N-tiles × deep trees → ``unfused``: encode once, spill the
         one-hot, instead of re-encoding per N-tile (float32, bfloat16 and
         int16 LUTs, as the JAX dispatch treats int16 like the float ones);
      4. otherwise → ``fused``.

    The TPU dispatch's minimum tile sizes (8 rows, 128 columns) describe
    MXU padding and do not apply here: on CUDA, ``auto`` never picks
    ``ref``, so a decode batch of any size reaches the kernel.
    """
    del b, c  # the CUDA rules depend on neither
    if device_type not in ("cuda", "meta"):  # meta: the card's shapes
        return "ref"
    if lut_dtype == torch.int8:
        return "fused"
    if (math.ceil(n / _UNFUSED_TILE_COLS) >= _UNFUSED_N_TILES
            and 2**depth >= _UNFUSED_MIN_G):
        return "unfused"
    return "fused"


def _to_split_values(x: Tensor, params: MaddnessParams,
                     input_kind: str) -> Tensor:
    if input_kind == "full":
        xs = gather_split_values(x, params.tree)
    elif input_kind == "split":
        xs = x
    elif input_kind == "package":
        plan = PruningPlan(
            keep_idx=torch.zeros((0,), dtype=torch.int64),  # gathered upstream
            consumer_codebooks=params.tree.num_codebooks,
            consumer_depth=params.tree.depth,
        )
        xs = pruned_to_split_values(x, plan)
    else:
        raise ValueError(
            f"input_kind must be one of {INPUT_KINDS}, got {input_kind!r}")
    # the encode compares in float32 (JAX promotes to the thresholds' type)
    return xs.to(torch.float32).contiguous()


def _run_ref(xs: Tensor, params: MaddnessParams,
             tiles: Optional[AT.TileConfig]) -> Tensor:
    del tiles
    if xs.device.type == "cuda":
        REF_ON_CUDA.bump()
    onehot = encode_onehot(xs, params.tree)
    return contract_onehot(onehot, params.lut, params.lut_scale,
                           params.lut_offset)


def _run_unfused(xs: Tensor, params: MaddnessParams,
                 tiles: Optional[AT.TileConfig]) -> Tensor:
    # int8 tables take an int8 one-hot as it is; float and int16 tables
    # a float32 one (the same 0/1 bits either way)
    out_dtype = (torch.int8 if params.lut.dtype == torch.int8
                 else torch.float32)
    b, c, depth = xs.shape
    plan = None if tiles is None else AT.encode_plan(tiles, b, c, depth)
    onehot = encode_onehot_cuda(xs, params.tree.thresholds,
                                out_dtype=out_dtype, launch_plan=plan)
    return lut_aggregate(onehot, params.lut, params.lut_scale,
                         params.lut_offset,
                         split_k=None if tiles is None else tiles.split_k)


def _run_fused(xs: Tensor, params: MaddnessParams,
               tiles: Optional[AT.TileConfig]) -> Tensor:
    b, c, depth = xs.shape
    plan = (None if tiles is None
            else AT.fused_plan(tiles, b, c, depth, params.lut.dtype))
    return FL.fused_lutmu(xs, params.tree.thresholds, params.lut,
                          params.lut_scale, params.lut_offset,
                          launch_plan=plan)


_RUNNERS = {"ref": _run_ref, "unfused": _run_unfused, "fused": _run_fused}


def lutmu_matmul(x: Tensor, params: MaddnessParams, *, backend: str = "auto",
                 input_kind: str = "full",
                 tiles: Optional[AT.TileConfig] = None,
                 autotune: bool = False,
                 cache: Optional[AT.AutotuneCache] = None) -> Tensor:
    """The unified LUT-MU entry point: ``x`` → approximate ``x @ W``.

    Args:
      x: the input, per ``input_kind``: ``"full"`` (B, D) activations;
        ``"split"`` (B, C, I) pre-gathered split values; ``"package"``
        (B, I·C) cluster-ordered pruned package from an upstream LUT-MU.
      params: tree + LUT (+ dequant epilogue); see :func:`params_from_arrays`.
      backend: ``"auto"`` (see :func:`select_backend`) or one of
        ``"ref" | "unfused" | "fused"``.  ``REPRO_LUTMU_BACKEND`` overrides
        ``"auto"``.
      tiles: an explicit launch plan (``autotune.TileConfig``); by default
        on CUDA tensors the autotuner resolves one (cache → measured if
        ``autotune`` → the wrappers' own pick).  CPU tensors run the plain
        versions, which take no plan.
      autotune: measure the ``fused`` cluster sizes of an unseen shape and
        persist the winner (also ``REPRO_AUTOTUNE=1``).
      cache: the autotune cache (default: ``autotune.get_default_cache()``).

    Returns:
      (B, N) float32.
    """
    return _run(_to_split_values(x, params, input_kind), params, backend,
                tiles, autotune, cache, input_kind)


def _run(xs: Tensor, params: MaddnessParams, backend: str,
         tiles: Optional[AT.TileConfig], autotune: bool,
         cache: Optional[AT.AutotuneCache], kind: str) -> Tensor:
    """Pick the backend and launch plan for the problem of split values
    ``xs`` (B, C, I), report it to the profile hook as ``kind``, and run
    it."""
    b, c, depth = xs.shape
    n = params.lut.shape[-1]
    if backend == "auto":
        backend = os.environ.get("REPRO_LUTMU_BACKEND", "auto")
    if backend == "auto":
        backend = select_backend(b, c, n, depth, params.lut.dtype,
                                 xs.device.type)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be 'auto' or one of {BACKENDS}, "
                         f"got {backend!r}")
    if _PROFILE_HOOK is not None:
        _PROFILE_HOOK(backend=backend, input_kind=kind, b=int(b),
                      c=int(c), n=int(n), depth=int(depth),
                      lut_dtype=str(params.lut.dtype))
    if xs.device.type == "meta":
        # a dry run (launch/dryrun.py): shapes only; the hook above is
        # how analysis/cost.py counts the call's work
        return torch.empty((b, n), dtype=torch.float32, device="meta")
    if backend == "ref" or xs.device.type != "cuda":
        tiles = None
    elif tiles is None:
        tiles = AT.get_tiles(b, c, n, depth, params.lut.dtype, backend=backend,
                             allow_measure=autotune, cache=cache,
                             device=xs.device)
    return _RUNNERS[backend](xs, params, tiles)


def lutmu_matmul_sharded(x: Tensor, params: MaddnessParams, *, mesh,
                         axis: str = "model", backend: str = "auto",
                         input_kind: str = "full",
                         tiles: Optional[AT.TileConfig] = None,
                         autotune: bool = False,
                         cache: Optional[AT.AutotuneCache] = None,
                         codebooks: Optional[int] = None,
                         comm=None) -> Tensor:
    """Codebook-sharded LUT-MU on a ``DeviceMesh``: per-shard aggregate +
    all-reduce, no gathers (the counterpart of the JAX ``shard_map``
    version).

    ``params`` holds this rank's shard of the codebook axis as
    ``distributed.sharding.shard_params`` places it on ``axis``; its
    epilogue vectors are whole.  ``codebooks`` is the whole table's
    codebook count C (default: the local count times the axis size).  The
    rank runs the chosen backend over its local codebooks with a unit scale
    and a zero offset, the pre-epilogue partials are summed over ``axis``,
    and the dequant epilogue runs once on the sum.  ``x``, per
    ``input_kind``: ``"full"`` (B, D) activations; ``"split"`` split values
    of this rank's codebooks (B, C/tp, I) or of all of them (B, C, I);
    ``"package"`` the whole (B, I·C) package.  Its rows are whatever this
    rank holds: under a mesh the model's rows are already split over the
    data axes, and the sum runs over ``axis`` only.

    Integer LUTs stay bit-identical to :func:`lutmu_matmul`: each rank's
    int32 partial is exact in float32 (below 2**24), so the sum and the one
    epilogue reproduce its arithmetic.  Float LUTs reassociate the codebook
    sum across shards.

    Backend and launch plan (``backend``, ``tiles``, ``autotune``,
    ``cache``, as :func:`lutmu_matmul` takes them) are chosen for the
    per-shard problem (B, C/tp), the shape the kernel runs.  Falls back to
    :func:`lutmu_matmul` on the tables as given when the axis has one rank
    or C does not divide by it (the rules replicate such tables).  The sum
    runs through ``comm`` (a ``ParallelContext``'s communicator; default:
    the mesh's process groups).
    """
    tp = mesh_shape(mesh)[axis]
    c_loc = params.tree.num_codebooks
    c = c_loc * tp if codebooks is None else int(codebooks)
    if tp <= 1 or c % tp != 0:
        return lutmu_matmul(x, params, backend=backend, input_kind=input_kind,
                            tiles=tiles, autotune=autotune, cache=cache)
    if c_loc * tp != c:
        raise ValueError(f"params hold {c_loc} codebooks, a {tp}-way shard "
                         f"of {c} holds {c // tp}")
    comm = MeshComm(mesh) if comm is None else comm
    rank = comm.rank((axis,))
    if input_kind == "full":
        xs = local_split_values(x, params, rank, c)
    elif input_kind in ("split", "package"):
        if input_kind == "package":
            x = pruned_to_split_values(x, PruningPlan(
                keep_idx=torch.zeros((0,), dtype=torch.int64),
                consumer_codebooks=c, consumer_depth=params.tree.depth))
        if x.shape[1] == c:
            x = x.narrow(1, rank * c_loc, c_loc)
        xs = x.to(torch.float32).contiguous()
    else:
        raise ValueError(
            f"input_kind must be one of {INPUT_KINDS}, got {input_kind!r}")
    # unit scale / zero offset: the epilogue runs once, after the sum
    unit = params_from_arrays(
        params.tree.split_dims, params.tree.thresholds, params.lut,
        torch.ones((), dtype=torch.float32, device=xs.device),
        torch.zeros((), dtype=torch.float32, device=xs.device))
    acc = _run(xs, unit, backend, tiles, autotune, cache,
               "sharded:" + input_kind).contiguous()
    acc = comm.all_reduce(acc, (axis,))
    return acc * params.lut_scale + params.lut_offset


def local_split_values(x: Tensor, params: MaddnessParams, rank: int,
                       codebooks: int) -> Tensor:
    """The split values of a codebook shard: full activations (B, D), whose
    D splits into ``codebooks`` equal subspaces, → (B, C_local, I) of the
    shard at ``rank`` (its tree's split dims index its own subspaces)."""
    c_loc = params.tree.num_codebooks
    width = x.shape[1] // codebooks * c_loc
    return _to_split_values(x.narrow(1, rank * width, width), params, "full")


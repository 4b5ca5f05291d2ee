"""Per-rank cost of one step run on ``meta`` tensors: what the dry-run
(``launch/dryrun.py``) records in place of XLA's ``cost_analysis``,
``memory_analysis`` and the collectives parsed from HLO.

A step's model functions run on one rank's shards, all ``meta`` (shapes and
dtypes, no storage, no kernel), under three counters:

  * **FLOPs** — ``torch.utils.flop_counter.FlopCounterMode``: the matrix
    products (``mm``, ``bmm``, ``einsum``'s products, convolutions,
    attention), forward, remat recompute and backward, as torch dispatches
    them.  Elementwise ops count none.
  * **bytes** — :class:`OpBytes`, a ``TorchDispatchMode`` summing every
    op's operand and result bytes.  It is an **unfused upper bound** on the
    step's memory traffic: every op reads its inputs from and writes its
    output to device memory, as no fused kernel does.  Views and
    allocations move nothing and count nothing.  The same mode tracks the
    live bytes of the storages the step creates, as they are made and
    freed: their peak is the step's temporary memory.
  * **LUT ops** — a LUT-MU call on ``meta`` tensors never reaches a kernel
    or the plain ``ref`` contraction (which reads its one-hot on the host);
    the dispatch hook reports its shape, and it counts ``B·C·N`` gather-adds
    and ``B·C·depth`` tree compares.

Collectives go through :class:`ShapeComm`, the shape-only communicator of a
``ParallelContext`` on an ``AbstractMesh``: each returns a correctly shaped
``meta`` tensor and counts its calls and bytes per kind — the model's
collectives and those of the serving state's placement alike: a split
sequence's partial softmax (an all-reduce of the row maxima, one of the
denominators, one of the value products) and a cut paged pool's view (a
reduce-scatter, or an all-reduce, of every row's masked pages).

This module takes the place of the JAX package's ``analysis/hlo_stats.py``
and ``analysis/scan_cost.py``: they parse XLA's HLO and correct
``cost_analysis``'s once-per-``while`` count, and a torch step run op by op
needs neither.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import pytree as T
from repro_torch.distributed.sharding import _shard_index, mesh_shape
from repro_torch.kernels import dispatch as D

Tensor = torch.Tensor

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def nbytes(t: Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    """The bytes of every tensor of a tree (``repro_torch.pytree``)."""
    return sum(nbytes(t) for t in T.leaves(tree))


class ShapeComm:
    """The shape-only communicator of a ``ParallelContext``: every
    collective returns a ``meta`` result of the right shape and counts, per
    kind, its calls and the bytes a rank moves, as the JAX package's
    ``hlo_stats`` counts a collective's: an all-reduce its operand, an
    all-gather the gathered result, a reduce-scatter its operand.  A group
    of one rank moves nothing and counts nothing.  The rank modelled is
    ``coord``, index 0 on every axis (the rule engine's guards keep the
    ranks symmetric)."""

    def __init__(self, mesh):
        self.shape = mesh_shape(mesh)
        self.coord = {a: 0 for a in self.shape}
        self.counts = {k: {"bytes": 0, "count": 0} for k in COLLECTIVE_KINDS}

    def size(self, axes: Tuple[str, ...]) -> int:
        return int(math.prod(self.shape[a] for a in axes))

    def rank(self, axes: Tuple[str, ...]) -> int:
        return _shard_index(axes, self.shape, self.coord)[1]

    def _count(self, kind: str, n: int, axes) -> None:
        if self.size(axes) > 1:
            self.counts[kind]["bytes"] += n
            self.counts[kind]["count"] += 1

    def all_reduce(self, x: Tensor, axes, op: str = "sum") -> Tensor:
        self._count("all-reduce", nbytes(x), axes)
        return x

    def all_gather(self, x: Tensor, dim: int, axes) -> Tensor:
        shape = list(x.shape)
        shape[dim] *= self.size(axes)
        out = x.new_empty(shape)
        self._count("all-gather", nbytes(out), axes)
        return out

    def reduce_scatter(self, x: Tensor, dim: int, axes) -> Tensor:
        shape = list(x.shape)
        shape[dim] //= self.size(axes)
        self._count("reduce-scatter", nbytes(x), axes)
        return x.new_empty(shape)

    def collectives(self) -> dict:
        """``{kind: {"bytes", "count"}, ..., "total_bytes"}`` (the JAX
        record's ``collectives``)."""
        out = {k: dict(v) for k, v in self.counts.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.counts.values())
        return out


_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.new_empty,
                torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
                torch.ops.aten.new_empty_strided}


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class OpBytes(TorchDispatchMode):
    """Sums each op's operand and result bytes (``bytes``), and tracks the
    live bytes of the storages created while it is active (``peak``).
    Storages of ``known`` tensors (the step's arguments) are not counted
    as created."""

    def __init__(self, known=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}
        for t in known:
            self._seen[t.untyped_storage()._cdata] = 0

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def _track(self, t: Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, Tensor)]
        if func.overloadpacket not in _ALLOCATIONS and not _is_view(func):
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, Tensor)]
            self.bytes += sum(nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


def run_counted(fn, *args):
    """``fn(*args)`` on ``meta`` tensors under the counters.  Returns the
    output and ``{"flops", "bytes", "lut_ops", "temp_peak_bytes"}``."""
    lut = {"ops": 0}

    def hook(*, b, c, n, depth, **_):
        lut["ops"] += b * c * n + b * c * depth

    ob = OpBytes(T.leaves(list(args)))
    with D.profile_hook_paused():
        D.set_profile_hook(hook)
        try:
            with FlopCounterMode(display=False) as fc, ob:
                out = fn(*args)
        finally:
            D.set_profile_hook(None)
    return out, {"flops": float(fc.get_total_flops()),
                 "bytes": float(ob.bytes), "lut_ops": float(lut["ops"]),
                 "temp_peak_bytes": int(ob.peak)}

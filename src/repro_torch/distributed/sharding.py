"""Sharding rules (PyTorch): FSDP × TP (× pod) for every architecture, as
in ``repro.distributed.sharding``, and the parallel context the model
functions take on a mesh.

The rules are pure metadata and equal the JAX package's rule for rule: a
spec is a tuple with one entry per leading dim of a leaf — ``None``, a mesh
axis name, or a tuple of names — the entries of the JAX ``PartitionSpec``
the same rule gives.  Policy (MaxText-style, adapted per family):

  * ``model`` axis = tensor parallelism over feature dims; attention
    projections shard only when the head count divides the axis (whole
    heads per shard), others fall back to FSDP;
  * ``data`` (+ ``pod``) axes = data parallel for activations and FSDP for
    params;
  * MoE experts: expert-parallel over ``model`` when E divides it, else
    TP inside each expert (its FF dim);
  * LUT-MU tables: TP over the codebook axis (the contraction dim);
  * every rule is divisibility-guarded: a dim that does not divide falls
    back to replication on that axis.

Rules match on the *trailing* dims of each leaf, so stacked-layer leading
axes (L, …) or (n_groups, …) are handled uniformly.  A mesh is a
``DeviceMesh`` or an :class:`AbstractMesh` (a shape and axis names, for
meshes this host cannot build).

:func:`shard_params` cuts a whole params tree to one rank's local shards,
:func:`shard_state` a train state (:func:`state_shardings`), and
:func:`unshard_state` gathers one whole again.  Mamba's packed leaves
(``in_proj``'s ``z | x | B | C | dt`` columns, the conv's ``x | B | C``
channels) are cut over ``model`` part by part where the block is cut
(:func:`mamba_tp_ok`): one table (:data:`_MAMBA_PARTS`) and one pair
(:func:`cut_parts` / :func:`join_parts`) that every cut and gather uses.
:class:`ParallelContext` takes the role of JAX's ``make_constrainer``:
JAX constrains shardings and lets GSPMD insert collectives and
differentiate them; here every rank holds its local shards and the model
functions call the collectives themselves, through the context
(``None`` off a mesh), each a ``torch.autograd.Function`` with its
adjoint: leaving a TP region sums forward, entering one sums the
gradient, an FSDP gather reduce-scatters it, the gather of a block every
rank computes whole slices it.  The train step's reduction of the
gradients follows one rule, :meth:`ParallelContext.grad_sum_axes`.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import pytree as T
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
Spec = Tuple  # entries: None | axis name | tuple of axis names


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, without devices."""

    shape_tuple: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape_tuple))


def mesh_shape(mesh) -> Dict[str, int]:
    """axis name → size of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical roles of the mesh axes."""

    dp: Tuple[str, ...]  # data-parallel (+pod) axes: ("pod","data") or ("data",)
    tp: str = "model"

    @classmethod
    def for_mesh(cls, mesh) -> "MeshAxes":
        names = tuple(mesh_shape(mesh))
        dp = tuple(n for n in names if n in ("pod", "data"))
        return cls(dp=dp, tp="model" if "model" in names else names[-1])

    def dp_size(self, mesh) -> int:
        shape = mesh_shape(mesh)
        return int(math.prod(shape[a] for a in self.dp))

    def tp_size(self, mesh) -> int:
        return int(mesh_shape(mesh)[self.tp])

    def dp_entry(self):
        return self.dp if len(self.dp) > 1 else self.dp[0]


# rule: (path regex, trailing-dim axis roles); roles: "fsdp" | "tp" | None
_Rule = Tuple[str, Tuple[Optional[str], ...]]


def _rules(cfg: ModelConfig, ep: bool, tp_size: int = 1) -> Sequence[_Rule]:
    moe_up = ("tp", "fsdp", None) if ep else (None, "fsdp", "tp")
    moe_down = ("tp", None, "fsdp") if ep else (None, "tp", "fsdp")
    # attention projections TP-shard only when the head *count* divides the
    # axis, so every shard holds whole heads; otherwise FSDP only
    q_tp = "tp" if cfg.num_heads % max(tp_size, 1) == 0 else None
    kv_tp = "tp" if cfg.num_kv_heads % max(tp_size, 1) == 0 else None
    return [
        (r"embed$", ("tp", "fsdp")),
        (r"lm_head$", ("fsdp", "tp")),
        (r"pos_embed$", (None, "fsdp")),
        # attention (flat head dims, head-aligned TP)
        (r"attn/wq$", ("fsdp", q_tp)),
        (r"attn/w[kv]$", ("fsdp", kv_tp)),
        (r"attn/wo$", (q_tp, "fsdp")),
        (r"attn/bq$", (q_tp,)),
        (r"attn/b[kv]$", (kv_tp,)),
        (r"cross/wq$", ("fsdp", q_tp)),
        (r"cross/w[kv]$", ("fsdp", kv_tp)),
        (r"cross/wo$", (q_tp, "fsdp")),
        # dense MLP
        (r"mlp/w_(gate|up)$", ("fsdp", "tp")),
        (r"mlp/w_down$", ("tp", "fsdp")),
        # MoE
        (r"moe/router$", (None, None)),
        (r"moe/w_(gate|up)$", moe_up),
        (r"moe/w_down$", moe_down),
        # Mamba
        (r"mamba/in_proj$", ("fsdp", "tp")),
        (r"mamba/out_proj$", ("tp", "fsdp")),
        (r"mamba/conv_w$", (None, "tp")),
        (r"mamba/conv_b$", ("tp",)),
        # LUT-MU tables: the codebook axis is the contraction dim → TP it
        # like an input-parallel weight; serving tables stay TP-only
        (r"amm_mlp/lut_(gate|up|down)$", ("tp", None, None)),
        (r"amm_mlp/.*(scale|offset)$", (None,)),
        (r"amm_mlp/.*(split_dims|thresholds)$", ("tp", None)),
        # norms & everything small: replicate
        (r".*", ()),
    ]


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict, paths joined with ``/``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """A nested dict's leaves by path."""
    out: Dict[str, object] = {}
    _map_with_path(lambda p, leaf: out.__setitem__(p, leaf), tree, prefix)
    return out


def unflatten(flat: Dict[str, object]) -> dict:
    """Leaves by path → the nested dict (:func:`flatten`'s inverse)."""
    out: dict = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _guarded_spec(shape: Tuple[int, ...], roles: Tuple[Optional[str], ...],
                  mesh, axes: MeshAxes) -> Spec:
    """A spec over the trailing dims with divisibility guards."""
    n_lead = len(shape) - len(roles)
    if n_lead < 0:  # rule longer than leaf rank: replicate
        return ()
    entries: list = [None] * n_lead
    for dim, role in zip(shape[n_lead:], roles):
        if role == "tp":
            entries.append(axes.tp if dim % axes.tp_size(mesh) == 0 else None)
        elif role == "fsdp":
            fs = axes.dp_size(mesh)
            entries.append(axes.dp_entry() if fs > 0 and dim % fs == 0
                           else None)
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def use_expert_parallel(cfg: ModelConfig, mesh, axes: MeshAxes) -> bool:
    return cfg.is_moe and cfg.num_experts % axes.tp_size(mesh) == 0


def param_shardings(params_shape, cfg: ModelConfig, mesh):
    """A params tree (tensors, ``meta`` ones included, or anything with a
    ``shape``) → the same tree of specs, by rule matching."""
    axes = MeshAxes.for_mesh(mesh)
    ep = use_expert_parallel(cfg, mesh, axes)
    rules = _rules(cfg, ep, axes.tp_size(mesh))

    def assign(path, leaf):
        for pattern, roles in rules:
            if re.search(pattern, path):
                return _guarded_spec(tuple(leaf.shape), roles, mesh, axes)
        return ()

    return _map_with_path(assign, params_shape)


def batch_spec(mesh, batch: int) -> Spec:
    """Input batch dim over all dp axes (divisibility-guarded)."""
    axes = MeshAxes.for_mesh(mesh)
    if batch % axes.dp_size(mesh) == 0:
        return (axes.dp_entry(),)
    return ()


def cache_shardings(cache_shape, cfg: ModelConfig, mesh, batch: int):
    """Fixed-slot KV/SSM cache specs.

    Default: batch over dp, kv-heads over tp when divisible (else the
    cache *sequence* over tp).  Long-context decode (batch not divisible by
    the dp degree) switches to **sequence sharding** over dp.
    """
    axes = MeshAxes.for_mesh(mesh)
    dp_ax = axes.dp_entry()
    dp_n, tp_n = axes.dp_size(mesh), axes.tp_size(mesh)
    seq_shard = batch % dp_n != 0

    def assign(path, leaf):
        shape = tuple(leaf.shape)
        if re.search(r"(^|/)(k|v|cross_k|cross_v)$", path) and len(shape) == 5:
            _, b, s, nkv, _ = shape
            kv_tp = nkv % tp_n == 0
            if not seq_shard:
                return (None, dp_ax if b % dp_n == 0 else None,
                        None if kv_tp else (axes.tp if s % tp_n == 0 else None),
                        axes.tp if kv_tp else None, None)
            if kv_tp:
                return (None, None, dp_ax if s % dp_n == 0 else None,
                        axes.tp, None)
            both = axes.dp + (axes.tp,)
            ok = s % (dp_n * tp_n) == 0
            return (None, None,
                    both if ok else (dp_ax if s % dp_n == 0 else None),
                    None, None)
        if re.search(r"mamba/ssm$", path) and len(shape) >= 4:
            # (L, B, nh, N, P): heads over tp, batch over dp when divisible
            ent = [None] * len(shape)
            if shape[1] % dp_n == 0:
                ent[1] = dp_ax
            if shape[2] % tp_n == 0:
                ent[2] = axes.tp
            return tuple(ent)
        if re.search(r"mamba/conv$", path) and len(shape) >= 3:
            ent = [None] * len(shape)
            if shape[1] % dp_n == 0:
                ent[1] = dp_ax
            if shape[-1] % tp_n == 0:
                ent[-1] = axes.tp
            return tuple(ent)
        if re.search(r"(^|/)enc$", path) and len(shape) == 3:
            return (dp_ax if shape[0] % dp_n == 0 else None,)
        return ()

    return _map_with_path(assign, cache_shape)


def paged_cache_shardings(cache_shape, cfg: ModelConfig, mesh):
    """Paged KV pool specs: ``(L, P, page_size, n_kv, hd)`` per k/v, the
    page axis over dp and kv-heads over tp, each when it divides.  The
    engines pad the pool to a multiple of the data degree
    (``PagedKVCache(pad_to=)``), so its pages always cut."""
    axes = MeshAxes.for_mesh(mesh)
    dp_ax = axes.dp_entry()

    def assign(path, leaf):
        shape = tuple(leaf.shape)
        if re.search(r"(^|/)(k|v)$", path) and len(shape) == 5:
            _, p, _, nkv, _ = shape
            return (None, dp_ax if p % axes.dp_size(mesh) == 0 else None,
                    None, axes.tp if nkv % axes.tp_size(mesh) == 0 else None,
                    None)
        return ()

    return _map_with_path(assign, cache_shape)


# ---------------------------------------------------------------------------
# local shards
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _shard_index(entry, shape: Dict[str, int], coord: Dict[str, int]):
    """(shard count, this rank's shard) of one spec entry: row-major over
    the entry's axes, as a ``NamedSharding`` places them."""
    n, idx = 1, 0
    for ax in _entry_axes(entry):
        n, idx = n * shape[ax], idx * shape[ax] + coord[ax]
    return n, idx


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One shard's shape (``NamedSharding.shard_shape``)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] //= math.prod(sizes[a] for a in _entry_axes(entry))
    return tuple(out)


def mesh_coord(mesh) -> Dict[str, int]:
    """This rank's index on every axis of a ``DeviceMesh``."""
    return {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names}


# Mamba's packed leaves: path → the parts their last dim packs, in order
# (``di`` = d_inner, ``gn`` = groups × state, ``nh`` = heads).  JAX's spec
# cuts the dim contiguously, which would mix the parts across ranks; under
# :func:`mamba_tp_ok` each part is cut on its own instead, so a rank holds
# its heads' z, x and dt columns and one slice of B and of C, and the
# conv's (and the cache's conv window's) channels to match
_MAMBA_PARTS = (
    (re.compile(r"(^|/)mamba/in_proj$"), ("di", "di", "gn", "gn", "nh")),
    (re.compile(r"(^|/)mamba/conv(_w|_b)?$"), ("di", "gn", "gn")),
)


def mamba_tp_ok(cfg: ModelConfig, tp: int) -> bool:
    """Whether a Mamba block is cut over ``tp`` model ranks: ``d_inner``,
    ``g·n`` and the head count divide ``tp``, and a rank's heads lie in
    whole groups or within one (``g % tp == 0`` or ``tp % g == 0``).
    Otherwise every model rank computes the block whole."""
    if not (cfg.is_ssm or cfg.is_hybrid):
        return False
    g = cfg.ssm_ngroups
    nh = cfg.d_inner // cfg.ssm_headdim
    return (cfg.d_inner % tp == 0 and (g * cfg.ssm_state) % tp == 0
            and nh % tp == 0 and (g % tp == 0 or tp % g == 0))


def mamba_parts(cfg: ModelConfig, path: str) -> Optional[Tuple[int, ...]]:
    """The part sizes of the last dim of the packed Mamba leaf at ``path``
    (:data:`_MAMBA_PARTS`); ``None`` for any other leaf."""
    sizes = {"di": cfg.d_inner, "gn": cfg.ssm_ngroups * cfg.ssm_state,
             "nh": cfg.d_inner // cfg.ssm_headdim}
    for pattern, parts in _MAMBA_PARTS:
        if pattern.search(path):
            return tuple(sizes[p] for p in parts)
    return None


def leaf_parts(cfg: ModelConfig, mesh, path: str
               ) -> Optional[Tuple[int, ...]]:
    """The parts the leaf at ``path`` is cut by over ``mesh``'s model axis
    (:func:`mamba_parts` where :func:`mamba_tp_ok` holds), else ``None``:
    a contiguous cut."""
    if not mamba_tp_ok(cfg, MeshAxes.for_mesh(mesh).tp_size(mesh)):
        return None
    return mamba_parts(cfg, path)


def cut_parts(t: Tensor, dim: int, parts: Sequence[int], n: int,
              i: int) -> Tensor:
    """Shard ``i`` of ``n`` of ``t`` along ``dim``, which packs ``parts``:
    each part's ``i``-th ``1/n``, in part order."""
    pieces, at = [], 0
    for size in parts:
        step = size // n
        pieces.append(t.narrow(dim, at + i * step, step))
        at += size
    return torch.cat(pieces, dim)


def join_parts(t: Tensor, dim: int, parts: Sequence[int], n: int) -> Tensor:
    """The whole of ``n`` shards made by :func:`cut_parts`, concatenated
    along ``dim`` in rank order (its inverse, bit for bit)."""
    shards = t.chunk(n, dim)
    pieces, at = [], 0
    for size in parts:
        step = size // n
        pieces.extend(s.narrow(dim, at, step) for s in shards)
        at += step
    return torch.cat(pieces, dim)


def take_shard(t: Tensor, spec: Spec, mesh, coord=None,
               parts: Optional[Sequence[int]] = None) -> Tensor:
    """The shard of ``t`` a rank at ``coord`` (default: this rank) holds:
    a contiguous copy when any dim is cut, else ``t`` itself.  With
    ``parts`` (:func:`leaf_parts`) the last dim is cut part by part."""
    coord = mesh_coord(mesh) if coord is None else coord
    sizes, out = mesh_shape(mesh), t
    for d, entry in enumerate(spec):
        n, i = _shard_index(entry, sizes, coord)
        if n > 1 and parts is not None and d == t.dim() - 1:
            out = cut_parts(out, d, parts, n, i)
        elif n > 1:
            step = out.shape[d] // n
            out = out.narrow(d, i * step, step)
    return t if out is t else out.contiguous().clone()


def leaf_cutter(cfg: ModelConfig, mesh, specs: Dict[str, Spec], coord=None):
    """``shard(path, leaf)`` → the shard of the leaf at ``path`` a rank
    holds (``specs``: path → spec), as ``init_params(shard=)`` and
    :func:`shard_params` cut each leaf."""
    return lambda path, t: take_shard(t, specs[path], mesh, coord,
                                      leaf_parts(cfg, mesh, path))


def shard_params(params: dict, cfg: ModelConfig, mesh, coord=None,
                 device=None) -> dict:
    """The whole params (``init_params`` or ``params_from_jax``) → this
    rank's local shard of every leaf, placed by :func:`param_shardings`.
    ``coord`` (axis → index) names another rank, e.g. on an
    :class:`AbstractMesh`.  The shards are cut where the tree lies and
    moved to ``device`` (default: left there): a tree on the host puts
    only this rank's shards on the card."""
    cut = leaf_cutter(cfg, mesh, flatten(param_shardings(params, cfg, mesh)),
                      coord)

    def one(path, t):
        s = cut(path, t)
        return s if device is None else s.to(device)

    return _map_with_path(one, params)


def _state_specs(state, param_specs: Dict[str, Spec]):
    """A ``TrainState``'s spec tree from its params' specs by path: ``mu``
    and ``nu`` placed as the params, both step counters replicated."""
    ps = unflatten(param_specs)
    return dataclasses.replace(
        state, params=ps,
        opt=dataclasses.replace(state.opt, step=(), mu=ps, nu=ps), step=())


def state_shardings(state_shape, cfg: ModelConfig, mesh):
    """The train state's placement (JAX's dry-run ``_state_shardings``):
    a ``TrainState`` of specs, params, ``mu`` and ``nu`` by
    :func:`param_shardings`, ``step`` replicated."""
    return _state_specs(state_shape, flatten(param_shardings(
        state_shape.params, cfg, mesh)))


def shard_state(state, cfg: ModelConfig, mesh, coord=None):
    """The whole train state → the shards a rank holds
    (:func:`state_shardings`; ``coord`` as :func:`shard_params` takes it),
    cut where the state lies.  A leaf no axis cuts is the whole leaf
    itself, not a copy."""
    return T.map_with_path(
        lambda path, t, spec: take_shard(t, spec, mesh, coord,
                                         leaf_parts(cfg, mesh, path)),
        state, state_shardings(state, cfg, mesh))


def unshard_state(state, par: "ParallelContext"):
    """This rank's train-state shards → the whole state on the host, leaf
    by leaf (one whole leaf on the device at a time).  Every rank of the
    mesh calls it: the leaves are all-gathered."""
    with torch.no_grad():
        return T.map_with_path(
            lambda path, t, spec: par.unshard(
                t, spec, parts=par.parts(path)).to("cpu", copy=True),
            state, par.state_specs(state))


# ---------------------------------------------------------------------------
# the communicators and the differentiable collectives
# ---------------------------------------------------------------------------


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class MeshComm:
    """The collectives of a ``("data", "model")`` ``DeviceMesh``, one process
    group per axis: the communicator a :class:`ParallelContext` runs on a
    real mesh (``analysis/cost.py::ShapeComm`` is the shape-only one).

    ``axes`` is a tuple of axis names (both axes: the world, whose ranks
    are row-major over ``("data", "model")`` as a ``NamedSharding`` orders
    them).  ``all_reduce`` sums (or, with ``op="max"``, takes the maximum
    of) a contiguous tensor in place; ``all_gather`` and ``reduce_scatter``
    concatenate and split along ``dim`` in rank order."""

    def __init__(self, mesh):
        names = tuple(mesh.mesh_dim_names)
        if names != ("data", "model"):
            raise ValueError(f"device meshes are ('data', 'model'), got "
                             f"{names}")
        self.mesh = mesh
        self.shape = mesh_shape(mesh)
        self.coord = mesh_coord(mesh)

    def size(self, axes: Tuple[str, ...]) -> int:
        return int(math.prod(self.shape[a] for a in axes))

    def rank(self, axes: Tuple[str, ...]) -> int:
        return _shard_index(axes, self.shape, self.coord)[1]

    def _group(self, axes: Tuple[str, ...]):
        if tuple(axes) == ("data", "model"):
            if self.mesh.size() != dist.get_world_size():
                raise ValueError("a collective over both axes needs a mesh "
                                 "over the whole world")
            return dist.group.WORLD
        (axis,) = axes
        return self.mesh.get_group(axis)

    def all_reduce(self, x: Tensor, axes: Tuple[str, ...],
                   op: str = "sum") -> Tensor:
        dist.all_reduce(x, op=_REDUCE_OPS[op], group=self._group(axes))
        return x

    def all_gather(self, x: Tensor, dim: int, axes: Tuple[str, ...]) -> Tensor:
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(self.size(axes))]
        dist.all_gather(parts, x.contiguous(), group=self._group(axes))
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, x: Tensor, dim: int,
                       axes: Tuple[str, ...]) -> Tensor:
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((xs.shape[0] // self.size(axes),)
                           + tuple(xs.shape[1:]))
        dist.reduce_scatter_tensor(out, xs, group=self._group(axes))
        return out.movedim(0, dim)

    def any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank of the world (every rank
        calls it, so it also holds each until all have come)."""
        dev = (torch.device("cuda", torch.cuda.current_device())
               if self.mesh.device_type == "cuda" else torch.device("cpu"))
        t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
        dist.all_reduce(t)
        return bool(t.item())


def _tracks_grad(x: Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _ExitTP(torch.autograd.Function):
    """Leave a TP region: the partials summed over ``model``; the gradient
    passes unchanged (every model rank computes the same one downstream)."""

    @staticmethod
    def forward(ctx, x, par):
        return par._all_reduce(x.clone(memory_format=torch.contiguous_format),
                               par.tp_axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterTP(torch.autograd.Function):
    """Enter a TP region (the replicated input of a column-parallel
    product): identity forward; backward, each model rank's partial
    gradient summed over ``model``."""

    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        par = ctx.par
        return par._all_reduce(g.clone(memory_format=torch.contiguous_format),
                               par.tp_axes), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``axes``.  Backward: with ``summed``
    the gradient reduce-scattered with a sum (an FSDP weight: each data
    rank saw other rows); without, this rank's slice (a block every rank
    computes whole, so every rank holds the same gradient)."""

    @staticmethod
    def forward(ctx, x, par, dim, axes, summed):
        ctx.par, ctx.dim, ctx.axes, ctx.summed = par, dim, axes, summed
        ctx.n = x.shape[dim]
        return par._all_gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        par, dim, axes = ctx.par, ctx.dim, ctx.axes
        if ctx.summed:
            gx = par._reduce_scatter(g, dim, axes)
        else:
            gx = g.narrow(dim, par.comm.rank(axes) * ctx.n, ctx.n)
        return gx, None, None, None, None


# ---------------------------------------------------------------------------
# the parallel context
# ---------------------------------------------------------------------------


# leaves the model functions read as TP shards (the others are gathered
# over ``model`` at use): attention and cross-attention only when both
# head counts divide tp (whole heads), Mamba's only under ``mamba_tp``
# (its part-wise shards: the rank's heads and channels), never the learned
# position tables (the rules' ``embed$`` puts their positions over
# ``model``, but every rank adds every position)
_GATHER_TP_ALWAYS = re.compile(r"(^|/)pos_embed$")
_ATTN_LEAF = re.compile(r"(^|/)(attn|cross)/")
_MAMBA_LEAF = re.compile(r"(^|/)mamba/")
# replicated leaves read inside a TP region, whose gradient on a model rank
# covers only that rank's heads (the per-head q/k norms under attention
# TP; Mamba's per-head and per-channel vectors under Mamba TP) or experts
# and FF slice (the MoE router under EP or TP in the expert)
_TP_PARTIAL_ATTN = re.compile(r"(^|/)attn/(q_norm|k_norm)$")
_TP_PARTIAL_MAMBA = re.compile(r"(^|/)mamba/(norm_w|a_log|dt_bias|d_skip)$")
_TP_PARTIAL_MOE = re.compile(r"(^|/)moe/router$")


class ParallelContext:
    """What a model function needs to run one rank's share of a step on a
    ``data × model`` mesh: the sizes and ranks, the parameter specs, the
    placement of the fixed-slot cache (:meth:`place_cache`) and of the
    paged pool (:meth:`pool_place`), and the collectives.

    Decode and prefill rows split over ``data`` when they divide
    (``batch_spec``); otherwise every data rank computes every row.  A
    train step's rows are the rank's :meth:`local_rows`.  Weights are read
    through :meth:`layer` / :meth:`read` / :meth:`leaf`, which all-gather
    the dims the rules put on ``data`` (FSDP) and, where the model computes
    a block whole, those on ``model``.  A Mamba block is cut over
    ``model`` under :attr:`mamba_tp` (its heads and channels; the packed
    leaves by :meth:`parts`), else computed whole.  The activations'
    collectives over ``model`` run on a group of one rank too (the path
    is the same at any tp); over one ``data`` rank none is issued, and no
    stored tensor is gathered over a group of one.  Every collective is
    differentiable (:meth:`enter_tp`, :meth:`reduce_tp`, the gathers);
    under no grad they run as plain collectives.

    ``comm`` is the one seam to the devices: :class:`MeshComm` on a
    ``DeviceMesh`` (the default), or a shape-only communicator on an
    :class:`AbstractMesh`, whose ``data`` axes may then be ``("pod",
    "data")``.  The model functions cannot tell which.
    """

    def __init__(self, cfg: ModelConfig, mesh, params_shape, comm=None):
        self.cfg = cfg
        self.mesh = mesh
        self.axes = MeshAxes.for_mesh(mesh)
        if (self.axes.tp != "model" or not self.axes.dp
                or not set(self.axes.dp) <= {"pod", "data"}):
            raise ValueError("meshes are ('data', 'model') or ('pod', "
                             f"'data', 'model'), got {tuple(mesh_shape(mesh))}")
        self.comm = MeshComm(mesh) if comm is None else comm
        self.dp_axes, self.tp_axes = self.axes.dp, (self.axes.tp,)
        self.dp = self.comm.size(self.dp_axes)
        self.tp = self.comm.size(self.tp_axes)
        self.dp_rank = self.comm.rank(self.dp_axes)
        self.tp_rank = self.comm.rank(self.tp_axes)
        self.ep = use_expert_parallel(cfg, mesh, self.axes)
        self.specs = flatten(param_shardings(params_shape, cfg, mesh))
        tp = self.tp
        # the rule engine's guards, per op (see _rules)
        self.attn_tp = cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0
        self.mlp_tp = cfg.d_ff % tp == 0
        self.moe_tp = (cfg.moe_d_ff or cfg.d_ff) % tp == 0
        self.vocab_tp = cfg.vocab_size % tp == 0
        self.mamba_tp = mamba_tp_ok(cfg, tp)
        self.collectives = 0  # collectives issued (a replay issues its own)
        self.cache_specs: Optional[Dict[str, Spec]] = None  # place_cache

    # -- configs -----------------------------------------------------------
    def attn_cfg(self, cfg: ModelConfig) -> ModelConfig:
        """The config an attention block runs at on this rank: its local
        heads under attention TP, else the whole config."""
        if not self.attn_tp:
            return cfg
        return dataclasses.replace(cfg, num_heads=cfg.num_heads // self.tp,
                                   num_kv_heads=cfg.num_kv_heads // self.tp,
                                   head_dim=cfg.resolved_head_dim)

    # -- rows ----------------------------------------------------------------
    def rows_split(self, b: int) -> bool:
        """Whether a batch of ``b`` rows splits over ``data`` (over more
        than one data rank: one rank holds every row)."""
        return self.dp > 1 and b % self.dp == 0

    def local_rows(self, x: Tensor, b: Optional[int] = None) -> Tensor:
        """This data rank's rows of a whole batch (all of them when the
        batch does not split)."""
        b = x.shape[0] if b is None else b
        if not self.rows_split(b):
            return x
        n = b // self.dp
        return x[self.dp_rank * n:(self.dp_rank + 1) * n]

    def gather_rows(self, x: Tensor, b: int) -> Tensor:
        """The whole batch from every data rank's rows (identity when the
        batch of ``b`` rows does not split)."""
        if not self.rows_split(b):
            return x
        return _Gather.apply(x, self, 0, self.dp_axes, True)

    # -- collectives ------------------------------------------------------------
    def _all_reduce(self, x: Tensor, axes, op: str = "sum") -> Tensor:
        self.collectives += 1
        return self.comm.all_reduce(x, axes, op)

    def _all_gather(self, x: Tensor, dim: int, axes) -> Tensor:
        self.collectives += 1
        return self.comm.all_gather(x, dim, axes)

    def _reduce_scatter(self, x: Tensor, dim: int, axes) -> Tensor:
        self.collectives += 1
        return self.comm.reduce_scatter(x, dim, axes)

    def reduce_tp(self, x: Tensor) -> Tensor:
        """Leave a TP region: ``x`` summed over the ``model`` group (under
        no grad in place on a contiguous copy of ``x``, or ``x`` itself)."""
        if _tracks_grad(x):
            return _ExitTP.apply(x, self)
        return self._all_reduce(x.contiguous(), self.tp_axes)

    def enter_tp(self, x: Tensor) -> Tensor:
        """Enter a TP region: ``x`` itself; its gradient is summed over
        ``model`` (each rank computes its heads', experts' or columns'
        part).  Nothing at all without a gradient to track."""
        return _EnterTP.apply(x, self) if _tracks_grad(x) else x

    def gather_tp(self, x: Tensor, dim: int) -> Tensor:
        """All-gather along ``dim`` over ``model`` (vocab-parallel logits);
        the gradient of this rank's slice passes back."""
        return _Gather.apply(x, self, dim, self.tp_axes, False)

    def share_tp(self, x: Tensor, dim: int) -> Tensor:
        """All-gather along ``dim`` over ``model`` of slices every rank
        then reads whole inside its TP region (Mamba's B and C): the
        gradient is summed over ``model`` and each rank keeps its slice
        (a reduce-scatter)."""
        return _Gather.apply(x, self, dim, self.tp_axes, True)

    def sum_tp(self, x: Tensor) -> Tensor:
        """``x`` summed over ``model`` where every rank goes on with its
        own part of the work (a norm's partial sums over the rank's
        channels): the gradient is summed over ``model`` too."""
        return self.enter_tp(self.reduce_tp(x))

    # -- stored tensors ------------------------------------------------------------
    def parts(self, path: str) -> Optional[Tuple[int, ...]]:
        """The parts the leaf at ``path`` (a param, a train-state or cache
        leaf) is cut by over ``model`` (:func:`leaf_parts`), or ``None``."""
        return mamba_parts(self.cfg, path) if self.mamba_tp else None

    def unshard(self, t: Tensor, spec: Spec, keep=(),
                parts: Optional[Sequence[int]] = None) -> Tensor:
        """``t`` (a local shard placed by ``spec``) gathered whole on every
        dim but those in ``keep``; groups of one rank are skipped.  Over
        ``data`` the gradient is reduce-scattered (summed), over ``model``
        sliced.  With ``parts`` (:meth:`parts`) the last dim was cut part
        by part, and is joined so (:func:`join_parts`)."""
        for d, entry in enumerate(spec):
            axes = _entry_axes(entry)
            if d in keep or not axes or self.comm.size(axes) == 1:
                continue
            t = _Gather.apply(t, self, d, axes, axes != self.tp_axes)
            if parts is not None and d == t.dim() - 1:
                t = join_parts(t, d, parts, self.comm.size(axes))
        return t

    def _keep_tp(self, path: str, spec: Spec) -> tuple:
        """Dims of a weight read as its TP shard."""
        if _GATHER_TP_ALWAYS.search(path):
            return ()
        if _ATTN_LEAF.search(path) and not self.attn_tp:
            return ()
        if _MAMBA_LEAF.search(path) and not self.mamba_tp:
            return ()
        return tuple(d for d, e in enumerate(spec) if "model" in _entry_axes(e))

    def leaf(self, params: dict, path: str) -> Tensor:
        """A top-level weight (``embed``, ``lm_head``, ``pos_embed``, …) as
        the model reads it."""
        t = params
        for k in path.split("/"):
            t = t[k]
        spec = self.specs[path]
        return self.unshard(t, spec, self._keep_tp(path, spec))

    def read(self, lp: dict, path: str) -> dict:
        """One layer's local params (entries of the stacks at ``path``:
        ``layers``, ``layers/pos0``, ``encoder/layers``) as the model reads
        them."""
        def one(sub, v):
            spec = self.specs[f"{path}/{sub}"][1:]  # the stack dim is whole
            return self.unshard(v, spec, self._keep_tp(sub, spec))

        return _map_with_path(one, lp)

    def layer(self, layers: dict, l: int, path: str) -> dict:
        """Layer ``l`` of the stack at ``path`` as the model reads it."""
        return self.read(_map_with_path(lambda _, v: v[l], layers), path)

    # -- training -------------------------------------------------------------
    def grad_sum_axes(self, path: str) -> Tuple[Tuple[str, ...], ...]:
        """The axes a train step sums the gradient of the param at ``path``
        over after backward.  The rule, in one place:

          * ``data``, unless the spec shards the leaf over it: its data
            ranks saw other rows.  A leaf sharded over ``data`` was
            gathered at use, and its gather's backward already summed
            (reduce-scattered) the rows' gradients.
          * ``model``, only for a replicated leaf read inside a TP region:
            the q/k norms under attention TP (each rank normalises its own
            heads), Mamba's ``norm_w``, ``a_log``, ``dt_bias`` and
            ``d_skip`` under Mamba TP (each rank reads its heads' and
            channels' slice) and the MoE router under expert parallelism
            or TP inside the expert (each rank weighs its own experts' or
            FF slice's outputs).  A TP-sharded leaf holds its own disjoint
            part; every other leaf is read outside a TP region (norms, the
            head's input, and attention or Mamba whose heads do not divide
            tp, computed whole), where the enter ops' sums leave every
            model rank the same whole gradient.
        """
        sharded = {a for e in self.specs[path] for a in _entry_axes(e)}
        out = []
        if not sharded & set(self.dp_axes):
            out.append(self.dp_axes)
        partial = ((self.attn_tp and _TP_PARTIAL_ATTN.search(path))
                   or (self.mamba_tp and _TP_PARTIAL_MAMBA.search(path))
                   or ((self.ep or self.moe_tp)
                       and _TP_PARTIAL_MOE.search(path)))
        if "model" not in sharded and partial:
            out.append(self.tp_axes)
        return tuple(out)

    def reduce_grads(self, paths, grads) -> None:
        """Sum each param's gradient (float32, in flatten order with its
        ``paths``) over its :meth:`grad_sum_axes`, in place, then divide
        every one by the data degree: the gradient of the mean of the data
        ranks' losses."""
        for path, g in zip(paths, grads):
            for axes in self.grad_sum_axes(path):
                if self.comm.size(axes) > 1:
                    buf = self._all_reduce(g.contiguous(), axes)
                    if buf is not g:
                        g.copy_(buf)
        if self.dp > 1:
            for g in grads:
                g.div_(self.dp)

    def mean_over_data(self, x: Tensor) -> Tensor:
        """The mean of a value over the data ranks (``x`` on one rank)."""
        if self.dp == 1:
            return x
        return self._all_reduce(x.clone(), self.dp_axes) / self.dp

    def global_sums(self, paths, sums):
        """Per-param values summed over the parts of the param the ranks
        hold (its spec's axes): each element of the whole param counted
        once, a replicated one once, not once per rank."""
        axes_of = [{_entry_axes(e) for e in self.specs[p]} for p in paths]
        todo = [a for a in (self.dp_axes, self.tp_axes)
                if self.comm.size(a) > 1]
        if not todo:
            return list(sums)
        vec = torch.stack(list(sums))
        for axes in todo:
            mask = torch.tensor([axes in s for s in axes_of],
                                device=vec.device)
            part = self._all_reduce(torch.where(mask, vec, 0.0), axes)
            vec = torch.where(mask, part, vec)
        return list(vec.unbind())

    def state_specs(self, state):
        """The spec tree of a train state on this context's mesh."""
        return _state_specs(state, self.specs)

    # -- the fixed-slot cache ----------------------------------------------------
    def place_cache(self, cache_shape, slots: int) -> Dict[str, Spec]:
        """The fixed-slot cache's placement (path → spec), kept on the
        context for the decode's reads: JAX's :func:`cache_shardings` for
        ``slots`` rows — attention K/V with their slots over ``data`` when
        they divide, kv heads over ``model`` under attention TP, else the
        cache *sequence* over ``model``, and for a batch that does not
        divide the data degree the sequence over ``data`` (and ``model``);
        a split sequence is read by the partial softmax of
        :meth:`seq_split`.  Under :attr:`mamba_tp` Mamba's SSM state holds
        the rank's heads and its conv window the rank's channels, cut part
        by part (:meth:`parts`); where the block is computed whole, both
        keep only their slots over ``data``."""
        specs = {}
        for path, spec in flatten(cache_shardings(
                cache_shape, self.cfg, self.mesh, slots)).items():
            if _MAMBA_LEAF.search(path) and not self.mamba_tp:
                spec = tuple(e if e is not None and "model" not in
                             _entry_axes(e) else None for e in spec)
            specs[path] = spec
        self.cache_specs = specs
        return specs

    def seq_split(self, path: str) -> Optional[Tuple[Tuple[str, ...], int]]:
        """``(axes, shard)`` of the K/V leaf at ``path`` of the placed
        cache when its sequence is cut over a group of more than one rank:
        the group's axes and this rank's shard index over them (row-major,
        so its first global position is ``shard`` times its length);
        ``None`` when every rank holds the whole sequence."""
        if self.cache_specs is None:
            raise ValueError("a fixed-slot cache on a mesh is placed first "
                             "(ParallelContext.place_cache)")
        spec = self.cache_specs[path]
        axes = _entry_axes(spec[2]) if len(spec) > 2 else ()
        if self.comm.size(axes) == 1:
            return None
        return axes, self.comm.rank(axes)

    def seq_slice(self, t: Tensor, path: str, dim: int = 2) -> Tensor:
        """This rank's slice of a whole-sequence K/V tensor (dim ``dim``)
        of the placed leaf at ``path`` (``t`` itself when uncut)."""
        cut = self.seq_split(path)
        if cut is None:
            return t
        n = t.shape[dim] // self.comm.size(cut[0])
        return t.narrow(dim, cut[1] * n, n)

    def seq_max(self, x: Tensor, axes) -> Tensor:
        """The elementwise maximum of ``x`` over the sequence group
        ``axes`` (the partial softmax's row maximum)."""
        return self._all_reduce(x.contiguous(), axes, "max")

    def seq_sum(self, x: Tensor, axes) -> Tensor:
        """``x`` summed over the sequence group ``axes`` (the partial
        softmax's denominators and value products)."""
        return self._all_reduce(x.contiguous(), axes)

    # -- the paged pool ------------------------------------------------------------
    @property
    def pool_cut(self) -> bool:
        """Whether a paged pool's pages are cut over ``data`` (more than
        one data rank: JAX's ``paged_cache_shardings`` on a pool padded
        to a multiple of the data degree)."""
        return self.dp > 1

    def pool_place(self, ids, held: int):
        """Global page ids (a tensor, or one int) → ``(mine, local)``:
        whether this data rank holds each page, and its index in the
        rank's shard, of a pool cut into shards of ``held`` pages in
        data-rank order (``local`` is meaningful only where ``mine``)."""
        local = ids - self.dp_rank * held
        return (local >= 0) & (local < held), local

    def pool_sum(self, x: Tensor, rows_split: bool) -> Tensor:
        """Pieces of pages that one data rank holds each and every other
        rank contributes as zeros, summed over ``data`` bitwise: the sum
        runs on int32 views of the bytes (one non-zero word per element,
        so no rounding and no sign of zero is lost).  ``x`` is ``(B, …)``
        with whole positions in its last dim; with ``rows_split`` each
        data rank gets its rows (a reduce-scatter), else all of them (an
        all-reduce)."""
        bits = x.contiguous().view(torch.int32)
        if rows_split:
            out = self._reduce_scatter(bits, 0, self.dp_axes)
        else:
            out = self._all_reduce(bits, self.dp_axes)
        return out.contiguous().view(x.dtype)

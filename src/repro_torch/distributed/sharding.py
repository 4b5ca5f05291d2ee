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

:func:`shard_params` cuts a whole params tree to one rank's local shards.
:class:`ParallelContext` takes the role of JAX's ``make_constrainer``: JAX
constrains shardings and lets GSPMD insert collectives; here every rank
holds its local shards and the model functions call the collectives
themselves, through the context (``None`` off a mesh).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

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
    page axis over dp and kv-heads over tp, each when it divides.  (The
    port's engines keep every page on every data rank: ROADMAP C9.)"""
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


def take_shard(t: Tensor, spec: Spec, mesh, coord=None) -> Tensor:
    """The shard of ``t`` a rank at ``coord`` (default: this rank) holds:
    a contiguous copy when any dim is cut, else ``t`` itself."""
    coord = mesh_coord(mesh) if coord is None else coord
    sizes, out = mesh_shape(mesh), t
    for d, entry in enumerate(spec):
        n, i = _shard_index(entry, sizes, coord)
        if n > 1:
            step = out.shape[d] // n
            out = out.narrow(d, i * step, step)
    return t if out is t else out.contiguous().clone()


def shard_params(params: dict, cfg: ModelConfig, mesh, coord=None,
                 device=None) -> dict:
    """The whole params (``init_params`` or ``params_from_jax``) → this
    rank's local shard of every leaf, placed by :func:`param_shardings`.
    ``coord`` (axis → index) names another rank, e.g. on an
    :class:`AbstractMesh`.  The shards are cut where the tree lies and
    moved to ``device`` (default: left there): a tree on the host puts
    only this rank's shards on the card."""
    flat = flatten(param_shardings(params, cfg, mesh))

    def one(path, t):
        s = take_shard(t, flat[path], mesh, coord)
        return s if device is None else s.to(device)

    return _map_with_path(one, params)


# ---------------------------------------------------------------------------
# the parallel context
# ---------------------------------------------------------------------------


# leaves the model functions read as TP shards (the others are gathered
# over ``model`` at use): attention and cross-attention only when both
# head counts divide tp (whole heads); Mamba's packed projections never
# (no op splits in_proj's concatenated z, x, B, C, dt cleanly, and the
# block is computed whole on every model rank)
_GATHER_TP_ALWAYS = re.compile(r"(^|/)mamba/")
_ATTN_LEAF = re.compile(r"(^|/)(attn|cross)/")


class ParallelContext:
    """What a model function needs to run one rank's share of a step on a
    ``data × model`` ``DeviceMesh``: the groups, the ranks, the parameter
    specs, the fixed-slot cache's placement, and the collectives.

    Decode rows split over ``data`` when they divide (``batch_spec``);
    otherwise every data rank computes every row.  Weights are read through
    :meth:`layer` / :meth:`leaf`, which all-gather the dims the rules put
    on ``data`` (FSDP) and, where the model computes a block whole, those
    on ``model``.  The activations' collectives over ``model`` run on a
    group of one rank too (the path is the same at any tp); over one
    ``data`` rank none is issued, and no stored tensor is gathered over a
    group of one.
    """

    def __init__(self, cfg: ModelConfig, mesh, params_shape):
        self.cfg = cfg
        self.mesh = mesh
        self.axes = MeshAxes.for_mesh(mesh)
        if self.axes.dp != ("data",) or self.axes.tp != "model":
            raise ValueError("serving meshes are ('data', 'model'), got "
                             f"{tuple(mesh_shape(mesh))}")
        self.dp = self.axes.dp_size(mesh)
        self.tp = self.axes.tp_size(mesh)
        self.dp_group = mesh.get_group("data")
        self.tp_group = mesh.get_group("model")
        self.dp_rank = mesh.get_local_rank("data")
        self.tp_rank = mesh.get_local_rank("model")
        self.ep = use_expert_parallel(cfg, mesh, self.axes)
        self.specs = flatten(param_shardings(params_shape, cfg, mesh))
        tp = self.tp
        # the rule engine's guards, per op (see _rules)
        self.attn_tp = cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0
        self.mlp_tp = cfg.d_ff % tp == 0
        self.moe_tp = (cfg.moe_d_ff or cfg.d_ff) % tp == 0
        self.vocab_tp = cfg.vocab_size % tp == 0
        self.collectives = 0  # collectives issued (a replay issues its own)

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
        return self.gather(x, 0, self.dp_group, self.dp)

    # -- collectives ------------------------------------------------------------
    def reduce_tp(self, x: Tensor) -> Tensor:
        """Sum of ``x`` over the ``model`` group (in place on a contiguous
        copy)."""
        x = x.contiguous()
        self.collectives += 1
        dist.all_reduce(x, group=self.tp_group)
        return x

    def gather(self, x: Tensor, dim: int, group, n: int) -> Tensor:
        """All-gather along ``dim`` over ``group`` of ``n`` ranks."""
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(n)]
        self.collectives += 1
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    def gather_tp(self, x: Tensor, dim: int) -> Tensor:
        return self.gather(x, dim, self.tp_group, self.tp)

    # -- stored tensors ------------------------------------------------------------
    def unshard(self, t: Tensor, spec: Spec, keep=()) -> Tensor:
        """``t`` (a local shard placed by ``spec``) gathered whole on every
        dim but those in ``keep``; groups of one rank are skipped."""
        for d, entry in enumerate(spec):
            if d in keep:
                continue
            for ax in _entry_axes(entry):
                n = self.dp if ax == "data" else self.tp
                if n > 1:
                    t = self.gather(t, d, self.dp_group if ax == "data"
                                    else self.tp_group, n)
        return t

    def _keep_tp(self, path: str, spec: Spec) -> tuple:
        """Dims of a weight read as its TP shard."""
        if _GATHER_TP_ALWAYS.search(path):
            return ()
        if _ATTN_LEAF.search(path) and not self.attn_tp:
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

    def layer(self, layers: dict, l: int, path: str) -> dict:
        """Layer ``l`` of the stack at ``path`` (``layers``,
        ``layers/pos0``, ``encoder/layers``) as the model reads it."""
        def one(sub, v):
            spec = self.specs[f"{path}/{sub}"][1:]  # the stack dim is whole
            return self.unshard(v[l], spec, self._keep_tp(sub, spec))

        return _map_with_path(one, layers)

    # -- the fixed-slot cache ----------------------------------------------------
    def cache_spec(self, path: str, shape: Sequence[int], slots: int) -> Spec:
        """Where a fixed-slot cache leaf of ``slots`` rows is stored: as the
        model computes on it, the slots over ``data`` when they split and,
        under attention TP, the kv heads over ``model``; every other dim
        whole.  (JAX's ``cache_shardings`` also cuts the sequence, SSM heads
        and conv channels, which the port computes whole: ROADMAP C9.)"""
        ent: list = [None] * len(shape)
        row = 0 if re.search(r"(^|/)enc$", path) else 1
        if len(shape) > row and shape[row] == slots and self.rows_split(slots):
            ent[row] = "data"
        if (self.attn_tp and len(shape) == 5
                and re.search(r"(^|/)(k|v|cross_k|cross_v)$", path)):
            ent[3] = "model"
        return tuple(ent)

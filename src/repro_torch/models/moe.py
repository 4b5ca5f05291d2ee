"""Mixture-of-Experts FFN with sort-based grouped dispatch (PyTorch), as in
``repro.models.moe``.

Token-choice top-k routing with per-group capacity (GShard-style dropping):
each batch row is one group; its ``S·k`` (token, expert) selections are
sorted stably by expert id, scattered into equal-capacity expert bins, run
through batched expert matmuls and gathered back.  Bin tensors are
``O(tokens · k · d)``, independent of the expert count.

The routing is integer and equals the JAX package's on the same top-k
indices: the stable argsort, the per-expert counts, each selection's rank
and slot, and the inverse map.  Experts are counted with ``scatter_add_``,
not ``torch.bincount`` (which reads its input's range on the host, and a
captured step program may not).  Selections past an expert's capacity all
write the one overflow row ``E·cap``, which is then dropped, so the
scatter's duplicate indices never reach a kept value.

The capacity ``min(max(int(capacity_factor·S·k/E), 1), S)`` depends on the
group's ``S``: a whole prompt, a padded prefill chunk and a one-token
decode step drop different selections (the reference's behaviour, kept).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def init_moe_params(cfg: ModelConfig, gen: torch.Generator,
                    dtype=torch.float32) -> dict:
    d, e = cfg.d_model, cfg.num_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    dev = gen.device

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
        return w.mul_(scale)

    return {
        "router": L.dense_init(gen, d, e, torch.float32),
        "w_gate": normal((e, d, ff), 1.0 / math.sqrt(d)),
        "w_up": normal((e, d, ff), 1.0 / math.sqrt(d)),
        "w_down": normal((e, ff, d), 1.0 / math.sqrt(ff)),
    }


def capacity(cfg: ModelConfig, s: int,
             capacity_factor: Optional[float] = None) -> int:
    """Slots per expert for a group of ``s`` tokens."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    return min(max(int(capacity_factor * s * k / e), 1), s)


def route(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Top-k of the router's float32 probabilities ``(B, S, E)``: values
    renormalised to sum to 1 and indices ``(B, S, k)``, the lower index
    first among equal probabilities (``lax.top_k``'s order; a stable
    descending sort gives it, which ``torch.topk`` does not promise)."""
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return topv, topi


def dispatch(topi: Tensor, num_experts: int, cap: int, e0: int = 0,
             e_local: Optional[int] = None) -> dict:
    """The integer routing of every group at once.  topi: (B, S, k).

    Returns ``order`` (B, S·k) the stable argsort of the flat expert ids,
    ``counts`` (B, E), ``rank`` and ``slot`` (B, S·k) of each sorted
    selection, ``keep`` (B, S·k) bool, and ``inv`` (B, S·k) int32: the slot
    of each selection in its original order.  Slots number the bins of the
    ``e_local`` experts from ``e0`` (default: all of them); a selection past
    its expert's capacity, or of another rank's expert, takes the overflow
    slot ``e_local·cap``."""
    b, s, k = topi.shape
    e, dev = num_experts, topi.device
    e_local = e if e_local is None else e_local
    flat_e = topi.reshape(b, s * k).to(torch.int64)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((b, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = (torch.arange(s * k, device=dev)[None]
            - torch.gather(starts, 1, sorted_e))
    keep = rank < cap
    rel = sorted_e - e0
    ok = keep & (rel >= 0) & (rel < e_local)
    slot = torch.where(ok, rel * cap + rank,
                       torch.full_like(rank, e_local * cap))
    inv = torch.zeros((b, s * k), dtype=torch.int64, device=dev)
    inv.scatter_(1, order, slot)  # a permutation: no duplicate targets
    return {"order": order, "counts": counts, "rank": rank, "keep": keep,
            "slot": slot, "inv": inv.to(torch.int32)}


def moe_apply(params: dict, x: Tensor, cfg: ModelConfig,
              capacity_factor: Optional[float] = None, par=None) -> Tensor:
    """x: (B, S, D) → (B, S, D).  Groups are batch rows.

    On a mesh (``par``): with expert parallelism (E divides ``model``)
    each rank holds ``E/tp`` experts from ``e0 = tp_rank · E/tp``, routes
    its own rows, bins only its experts and combines locally; one
    all-reduce over ``model`` sums the ranks' partial outputs (JAX's
    ``_moe_apply_shard_map``).  Otherwise each rank holds a slice of every
    expert's FF dim (TP inside the expert) and the row-parallel down
    projection's partials are summed the same way.  Either way ``x``
    enters a TP region: the router and the bins see it whole, and its
    gradient is the sum of the ranks' parts.  The capacity rule is the
    single-device one."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    dtype = x.dtype
    tp = par is not None and (par.ep or par.moe_tp)
    if tp:
        x = par.enter_tp(x)
    logits = (x @ params["router"].to(dtype)).to(torch.float32)
    topv, topi = route(torch.softmax(logits, dim=-1), k)
    cap = capacity(cfg, s, capacity_factor)
    e_local, e0 = e, 0
    if par is not None and par.ep:
        e_local = e // par.tp
        e0 = par.tp_rank * e_local
    r = dispatch(topi, e, cap, e0, e_local)

    # bins: each kept selection's token row at its slot; the overflow row
    # e_local*cap takes every dropped one and is cut off
    sorted_tok = r["order"] // k
    rows = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    bins = torch.zeros((b, e_local * cap + 1, d), dtype=dtype,
                       device=x.device)
    bins[rows, r["slot"]] = x[rows, sorted_tok]
    bins = bins[:, :e_local * cap].reshape(b, e_local, cap, d)

    w_gate = params["w_gate"].to(dtype)
    w_up = params["w_up"].to(dtype)
    w_down = params["w_down"].to(dtype)
    h = L.ACTS[cfg.act](torch.einsum("becd,edf->becf", bins, w_gate))
    h = h * torch.einsum("becd,edf->becf", bins, w_up)
    out_bins = torch.einsum("becf,efd->becd", h, w_down)

    # combine: each selection's expert output (0 where it was dropped or
    # is another rank's), weighted by its renormalised probability, summed
    # over k
    flat = torch.cat([out_bins.reshape(b, e_local * cap, d),
                      torch.zeros((b, 1, d), dtype=dtype, device=x.device)],
                     dim=1)
    inv = r["inv"].to(torch.int64)
    gathered = torch.gather(flat, 1, inv[:, :, None].expand(b, s * k, d))
    gathered = gathered.reshape(b, s, k, d)
    out = (gathered * topv[..., None].to(dtype)).sum(dim=2)
    return par.reduce_tp(out) if tp else out


def aux_load_balance_loss(logits: Tensor, topi: Tensor,
                          num_experts: int) -> Tensor:
    """Switch-style auxiliary load-balancing loss (mean fraction · mean
    prob)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    me = probs.mean(dim=(0, 1))
    one_hot = torch.nn.functional.one_hot(topi[..., 0].to(torch.int64),
                                          num_experts).to(torch.float32)
    ce = one_hot.mean(dim=(0, 1))
    return num_experts * torch.sum(me * ce)

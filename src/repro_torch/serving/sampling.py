"""Stochastic sampling for the serving stack (the port of
``repro.serving.sampling``): per-request counter-derived random streams,
the temperature → top-k → top-p transforms and the speculative
rejection-sampling correction.

* **Streams equal to JAX's.**  Every random decision of a request is a pure
  function of ``(seed, emission index, role)``: the key of the ``t``-th
  emitted token is ``fold_in(fold_in(PRNGKey(seed), t), role)`` and its
  uniform is ``jax.random.uniform(key, ())``.  :func:`threefry2x32` is the
  Threefry-2x32 hash of ``jax._src.prng`` (20 rounds, key injection every
  four), and the uniform draw is JAX's: the key hashes the counter pair
  ``(0, 0)`` and the two output words are xor-ed, which is JAX's
  ``jax_threefry_partitionable=True`` mode, the default of the installed
  jax 0.9.0 (ROADMAP C1).  ``tests/test_torch_sampling.py`` holds the words
  and uniforms bit-equal to live JAX and fails, naming C1, if the installed
  JAX's default mode ever differs.  torch has no uint32 arithmetic on CUDA
  and ``>>`` on int32 is arithmetic, so the hash runs on int64 tensors
  masked to 32 bits after every add, rotate and xor.
* **Greedy is T = 0** of the same path: :func:`sampling_probs` gives a
  one-hot at the argmax, which :func:`categorical_from_uniform` maps to the
  argmax for every uniform.  The engines skip the sampler when every row
  of a step is greedy and take the argmax directly: the same tokens.
* **Capturable.**  Nothing branches on a tensor's value on the host (no
  ``.item()``, no ``nonzero``): greedy rows go through ``torch.where``, so
  the engines run the sampler inside their captured step programs.  The
  float and uint32 inputs travel through a program's int32 buffer as bit
  views (:func:`stage_rows`, :func:`from_staged`).

Ties follow JAX: ``jnp.argsort(descending=True)`` is stable, lower vocab
ids first, and so is ``torch.sort(stable=True, descending=True)``; the
inverse permutation is a ``scatter_``.  Functions take tensors on any
device and keep their work there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

# Decision roles: independent sub-streams per emitted-token index.  The
# plain sampler and the speculative bonus token share ROLE_SAMPLE.
ROLE_SAMPLE = 0
ROLE_ACCEPT = 1
ROLE_RESIDUAL = 2
ROLE_DRAFT = 3

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = int(np.array(1.0, np.float32).view(np.int32))


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (host-side only).

    ``temperature == 0`` is greedy argmax (``top_k``/``top_p``/``seed`` are
    then irrelevant); ``top_k == 0`` and ``top_p == 1`` disable their
    filters; ``seed`` fixes the request's stream given its prompt.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {self.top_k}")
        if not 0 < self.top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if not 0 <= self.seed < 2**32:
            raise ValueError(f"seed must fit in uint32, got {self.seed}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0


# ---------------------------------------------------------------------------
# Threefry-2x32 and the per-request streams.
# ---------------------------------------------------------------------------


def _u32(x) -> Tensor:
    """An integer tensor as int64 holding its uint32 bits (int32 wraps)."""
    return x.to(torch.int64) & _MASK


def threefry2x32(k0: Tensor, k1: Tensor, x0: Tensor, x1: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """The Threefry-2x32 hash of counters ``(x0, x1)`` under key
    ``(k0, k1)``: int64 tensors holding uint32 values, broadcast together;
    returns the two output words the same way."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _fold_in(key: Tuple[Tensor, Tensor], data: Tensor) -> Tuple[Tensor, Tensor]:
    # jax.random.fold_in: hash the counter pair (0, data)
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def _word(x, device) -> Tensor:
    # a Python int becomes a device fill, never a host copy (which a
    # captured program may not make)
    if isinstance(x, Tensor):
        return _u32(x.to(device))
    if isinstance(x, int):
        return torch.full((), x & _MASK, dtype=torch.int64, device=device)
    return _u32(torch.as_tensor(np.asarray(x).astype(np.int64), device=device))


def _stream_words(seed, t, role) -> Tuple[Tensor, Tensor]:
    device = seed.device if isinstance(seed, Tensor) else torch.device("cpu")
    seed, t, role = torch.broadcast_tensors(
        _word(seed, device), _word(t, device), _word(role, device))
    key = (torch.zeros_like(seed), seed)  # jax.random.PRNGKey(uint32 seed)
    return _fold_in(_fold_in(key, t), role)


def stream_key(seed, t, role) -> Tensor:
    """The key words ``(..., 2)`` (int64 holding uint32) of one random
    decision ``(seed, emission index, role)``, broadcast over tensors;
    ``fold_in(fold_in(PRNGKey(seed), t), role)``."""
    return torch.stack(_stream_words(seed, t, role), dim=-1)


def stream_uniform(seed, t, role) -> Tensor:
    """float32 U[0, 1) draws, one per broadcast ``(seed, t, role)``:
    ``jax.random.uniform(stream_key(seed, t, role), ())``."""
    k0, k1 = _stream_words(seed, t, role)
    zero = torch.zeros_like(k0)
    b0, b1 = threefry2x32(k0, k1, zero, zero)
    bits = ((b0 ^ b1) >> 9) | _ONE_BITS  # 23 random mantissa bits in [1, 2)
    return bits.to(torch.int32).view(torch.float32) - 1.0


# ---------------------------------------------------------------------------
# Logit transforms.
# ---------------------------------------------------------------------------


def _as(x, like: Tensor, dtype) -> Tensor:
    return torch.as_tensor(x, dtype=dtype, device=like.device)


def _softmax(x: Tensor) -> Tensor:
    # jax.nn.softmax's formula: exp(x - max) / sum
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _order_ranks(logits: Tensor) -> Tuple[Tensor, Tensor]:
    """The stable descending order of each row and its inverse."""
    order = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    iota = torch.arange(logits.shape[-1], device=logits.device)
    ranks = torch.empty_like(order).scatter_(-1, order,
                                             iota.expand_as(order))
    return order, ranks


def apply_temperature(logits: Tensor, temperature) -> Tensor:
    """``logits / T`` with T broadcast over the vocab axis; rows with
    T <= 0 pass through unscaled (the greedy branch replaces them)."""
    t = _as(temperature, logits, logits.dtype)
    safe = torch.where(t > 0, t, torch.ones_like(t))
    return logits / safe[..., None]


def apply_top_k(logits: Tensor, k) -> Tensor:
    """Keep exactly ``min(k, V)`` entries (the largest, ties toward lower
    vocab ids), the rest -inf; ``k <= 0`` disables the filter."""
    v = logits.shape[-1]
    _, ranks = _order_ranks(logits)
    kk = _as(k, logits, torch.int64)
    limit = torch.where((kk > 0) & (kk < v), kk, torch.full_like(kk, v))
    return torch.where(ranks < limit[..., None], logits,
                       torch.full_like(logits, -torch.inf))


def apply_top_p(logits: Tensor, p) -> Tensor:
    """Nucleus filter: keep the minimal probability-sorted prefix whose mass
    reaches ``p`` (the crossing token included), the rest -inf; ``p >= 1``
    disables it and the top token is always kept."""
    probs = _softmax(logits)
    order, ranks = _order_ranks(logits)
    sp = torch.gather(probs, -1, order)
    csum = torch.cumsum(sp, dim=-1)
    pp = _as(p, logits, logits.dtype)[..., None]
    keep_sorted = (csum - sp) < pp  # mass strictly before me < p
    keep_sorted[..., 0].fill_(True)  # a device fill for a 1-d row too
    keep = torch.gather(keep_sorted, -1, ranks)
    masked = torch.where(keep, logits, torch.full_like(logits, -torch.inf))
    return torch.where(pp < 1.0, masked, logits)


def sampling_probs(logits: Tensor, temperature, top_k, top_p) -> Tensor:
    """softmax(top_p(top_k(logits / T))) per row; T == 0 rows get a one-hot
    at ``argmax(logits)`` (first index on ties)."""
    x = apply_temperature(logits, temperature)
    x = apply_top_k(x, top_k)
    x = apply_top_p(x, top_p)
    probs = _softmax(x)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (iota == torch.argmax(logits, dim=-1, keepdim=True)
              ).to(probs.dtype)
    greedy = _as(temperature, logits, logits.dtype) <= 0
    return torch.where(greedy[..., None], onehot, probs)


def categorical_from_uniform(probs: Tensor, u: Tensor) -> Tensor:
    """Inverse-CDF sample: the smallest index whose cumulative mass exceeds
    ``u * total`` (unnormalised weights work directly).  Zero-probability
    categories are never returned; a one-hot returns its hot index for
    every ``u``."""
    csum = torch.cumsum(probs, dim=-1)
    total = csum[..., -1:]
    tok = (csum <= u[..., None] * total).to(torch.int32).sum(dim=-1)
    return torch.clamp(tok, max=probs.shape[-1] - 1).to(torch.int32)


def sample_tokens(logits: Tensor, seed, t, temperature, top_k,
                  top_p) -> Tensor:
    """``logits (B, V)`` + per-row ``(seed, t, temperature, top_k, top_p)``
    → ``(B,)`` int32 tokens; row ``b`` depends on its own parameters
    only."""
    probs = sampling_probs(logits, temperature, top_k, top_p)
    return categorical_from_uniform(probs, stream_uniform(seed, t,
                                                          ROLE_SAMPLE))


# ---------------------------------------------------------------------------
# Per-row inputs of a batch, and their int32 staging.
# ---------------------------------------------------------------------------


def batch_rows(rows_reqs: List[Tuple[int, object]], batch: int):
    """Per-row sampling arrays ``(seed, t, temperature, top_k, top_p)`` for
    a batch from ``(row, request)`` pairs; inactive rows are greedy.  ``t``
    is the emission index of the next token, ``len(req.generated)``."""
    seed = np.zeros((batch,), np.uint32)
    t = np.zeros((batch,), np.int32)
    temp = np.zeros((batch,), np.float32)
    top_k = np.zeros((batch,), np.int32)
    top_p = np.ones((batch,), np.float32)
    for row, req in rows_reqs:
        sp = req.sampling
        seed[row] = sp.seed
        t[row] = len(req.generated)
        temp[row] = sp.temperature
        top_k[row] = sp.top_k
        top_p[row] = sp.top_p
    return seed, t, temp, top_k, top_p


STAGED = ("seed", "t", "temperature", "top_k", "top_p")


def staged_inputs(batch: int) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """A step program's sampling inputs ``(shape, idle value)``: int32 bit
    views; idle rows are greedy (temperature 0.0, top_p 1.0)."""
    idle = {"seed": 0, "t": 0, "temperature": 0, "top_k": 0,
            "top_p": _ONE_BITS}
    return {k: ((batch,), idle[k]) for k in STAGED}


def stage_rows(rows_reqs, batch: int) -> Dict[str, np.ndarray]:
    """:func:`batch_rows` as int32 bit views, keyed as :data:`STAGED`."""
    arrays = batch_rows(rows_reqs, batch)
    return {k: a.view(np.int32) for k, a in zip(STAGED, arrays)}


def from_staged(seed: Tensor, t: Tensor, temperature: Tensor, top_k: Tensor,
                top_p: Tensor) -> Tuple[Tensor, ...]:
    """The int32 buffers of :func:`stage_rows` back as ``(seed (int64
    holding uint32), t, temperature (float32), top_k, top_p (float32))``,
    on the device, without a copy to the host."""
    return (_u32(seed), t, temperature.view(torch.float32), top_k,
            top_p.view(torch.float32))


def all_greedy(rows_reqs) -> bool:
    """Whether every listed request is greedy (the engines then take the
    argmax, bit-equal to the sampler's one-hot path)."""
    return all(req.sampling.greedy for _, req in rows_reqs)


# ---------------------------------------------------------------------------
# Speculative rejection-sampling correction.
# ---------------------------------------------------------------------------


def round_uniforms(seed: Tensor, t0: Tensor, n_valid: Tensor, k: int
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Every uniform of one speculative round in one batched hash:
    ``(u_draft, u_accept, u_residual)`` of shape ``(B, k)`` at emission
    indices ``t0 + j``, and ``u_bonus (B,)`` at ``t0 + max(n_valid-1, 0)``.
    None depends on a drafted token, so they can all be drawn up front;
    each equals :func:`stream_uniform` of its own ``(seed, t, role)``."""
    j = torch.arange(k, device=t0.device, dtype=t0.dtype)
    tj = t0[:, None] + j
    t_bonus = t0 + torch.clamp(n_valid - 1, min=0).to(t0.dtype)
    t = torch.cat([tj, tj, tj, t_bonus[:, None]], dim=1)  # (B, 3k+1)
    # fills on the device: a Python scalar assigned to a 0-d slice would be
    # a host copy, which a captured program may not make
    role = torch.full((3 * k + 1,), ROLE_SAMPLE, dtype=torch.int64,
                      device=t0.device)
    role[:k].fill_(ROLE_DRAFT)
    role[k:2 * k].fill_(ROLE_ACCEPT)
    role[2 * k:3 * k].fill_(ROLE_RESIDUAL)
    u = stream_uniform(seed[:, None], t, role)
    return u[:, :k], u[:, k:2 * k], u[:, 2 * k:3 * k], u[:, 3 * k]


def speculative_accept(p_probs: Tensor, q_probs: Tensor, draft: Tensor,
                       seed, t0: Tensor, n_valid: Tensor,
                       uniforms: Optional[Tuple[Tensor, Tensor, Tensor]] = None
                       ) -> Tuple[Tensor, Tensor]:
    """The rejection-sampling correction of one draft+verify round.

    ``p_probs (B, W, V)``: the target's post-transform distribution at each
    window position (position ``j`` is emission index ``t0 + j``);
    ``q_probs (B, K, V)``: the draft's, K = W - 1; ``draft (B, K)``: the
    proposals; ``seed/t0/n_valid (B,)``.  Proposal ``j`` is accepted iff
    ``u_j * q_j(x_j) < p_j(x_j)`` (``ROLE_ACCEPT``); the first rejected
    position is resampled from ``max(p_j - q_j, 0)`` (``ROLE_RESIDUAL``);
    on full acceptance the bonus token comes from ``p`` at the last live
    position (``ROLE_SAMPLE``, the plain engine's stream).  ``uniforms``:
    ``(u_accept, u_residual, u_bonus)`` drawn already
    (:func:`round_uniforms`), else drawn here.

    Returns ``(accepted (B,) int32, emit (B, W) int32)``: row ``b`` emits
    ``emit[b, :accepted[b] + 1]``.
    """
    b, w, v = p_probs.shape
    k = w - 1
    t0 = torch.as_tensor(t0)
    last_pos = torch.clamp(n_valid - 1, min=0)
    if uniforms is None:
        tj = t0[:, None] + torch.arange(k, device=t0.device, dtype=t0.dtype)
        seed_b = seed[:, None]
        uniforms = (stream_uniform(seed_b, tj, ROLE_ACCEPT),
                    stream_uniform(seed_b, tj, ROLE_RESIDUAL),
                    stream_uniform(seed, t0 + last_pos.to(t0.dtype),
                                   ROLE_SAMPLE))
    u_acc, u_res, u_bonus = uniforms
    j = torch.arange(k, device=draft.device)[None, :]
    idx = draft.to(torch.int64)[..., None]
    p_head = p_probs[:, :k]
    p_x = torch.gather(p_head, -1, idx)[..., 0]
    q_x = torch.gather(q_probs, -1, idx)[..., 0]
    # u*q < p  ⇔  u < p/q without the division; strict < keeps T=0 exact
    ok = (u_acc * q_x < p_x) & (j < (n_valid[:, None] - 1))
    accepted = torch.cumprod(ok.to(torch.int32), dim=-1).sum(dim=-1)
    resid = torch.clamp(p_head - q_probs, min=0.0)
    res_tok = categorical_from_uniform(resid, u_res)  # (B, K)
    p_last = torch.gather(
        p_probs, 1, last_pos.to(torch.int64)[:, None, None].expand(b, 1, v)
    )[:, 0]
    bonus = categorical_from_uniform(p_last, u_bonus)  # (B,)
    full = accepted >= last_pos
    res_at_a = torch.gather(res_tok, -1, torch.clamp(
        accepted, max=k - 1).to(torch.int64)[:, None])[:, 0]
    last = torch.where(full, bonus, res_at_a)
    jw = torch.arange(w, device=draft.device)[None, :]
    draft_pad = torch.nn.functional.pad(draft.to(torch.int32), (0, 1))
    emit = torch.where(jw == accepted[:, None], last[:, None], draft_pad)
    return accepted.to(torch.int32), emit.to(torch.int32)

"""Shared building blocks (PyTorch), as in ``repro.models.layers``.

Params are plain tensors; the compute dtype is the caller's (weights are
cast at use sites).  Init helpers draw from an explicit ``torch.Generator``
directly on the generator's device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> Tensor:
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                    device=gen.device)
    return w.mul_(1.0 / math.sqrt(d_in))


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=dtype, device=gen.device)
    return w.mul_(0.02)


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-6) -> Tensor:
    """RMS norm in float32, scaled by ``(1 + weight)``."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.to(torch.float32))).to(dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S).

    The permutation form of the JAX package: full-width cos/sin and a
    static half-swap with a sign, bit-identical to the split-halves form.
    """
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cat([cos, cos], dim=-1)
    sin = torch.cat([sin, sin], dim=-1)
    half = hd // 2
    perm = torch.arange(hd, device=x.device).roll(-half)  # second half first
    sign = torch.ones(hd, device=x.device)
    sign[:half] = -1.0
    xf = x.to(torch.float32)
    rot = xf[..., perm] * sign
    return (xf * cos + rot * sin).to(x.dtype)


# jax.nn.gelu defaults to the tanh approximation
ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu}


def gated_mlp(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor,
              act: str = "silu") -> Tensor:
    h = ACTS[act](x @ w_gate) * (x @ w_up)
    return h @ w_down

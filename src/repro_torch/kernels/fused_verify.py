"""The one masked attention read of the paged decode path.

``decode_attend`` lives here, as in ``repro/kernels/fused_verify.py``, so
the decode path and the speculative verify window (a later slice, with its
CUDA kernel) share one definition.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

Tensor = torch.Tensor

NEG_INF = -1e30


def decode_attend(qg: Tensor, cache_k: Tensor, cache_v: Tensor, pos_b: Tensor,
                  window: Optional[int]) -> Tensor:
    """Masked one-token attention read over a ``(B, S, n_kv, hd)`` cache
    view.  qg: (B, 1, n_kv, g, hd); returns (B, 1, n_kv, g, hd) float32.

    The products accumulate in float32 over the upcast cache, as the JAX
    ``preferred_element_type=f32`` einsums do; the softmax weights are
    rounded to the cache's type before the value product.
    """
    if cache_k.dtype == torch.int8:
        raise NotImplementedError(
            "int8 KV cache (cfg.amm.kv_int8) is not ported yet "
            "(ROADMAP A5)")
    hd = qg.shape[-1]
    kv_pos = torch.arange(cache_k.shape[1], device=qg.device)
    valid = kv_pos[None, :] <= pos_b[:, None]  # (B, S)
    if window is not None:
        valid = valid & (kv_pos[None, :] > pos_b[:, None] - window)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bsngh,btnh->bngst", qg.float(),
                          cache_k.float()) * scale
    logits = torch.where(valid[:, None, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bngst,btnh->bsngh", w.to(cache_v.dtype).float(),
                        cache_v.float())

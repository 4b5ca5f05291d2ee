"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) mixer (PyTorch), as
in ``repro.models.mamba``.

The chunked SSD algorithm for training and prefill (quadratic inside
fixed-size chunks, a linear recurrence between chunks) and the O(1)-state
recurrent step for decode.  Used by ``mamba2-370m`` and the Mamba positions
of ``jamba-1.5-large``.

Shapes (per layer): ``d_inner = expand · d_model``; ``nh = d_inner /
headdim`` heads of dim P; state N = ``ssm_state``; G = ``ssm_ngroups``
(B/C shared within a group).  The decode state is ``{"conv": (B, K-1,
conv_dim), "ssm": (B, nh, N, P) float32}``, constant in sequence length;
:func:`mamba_decode_step` updates it in place.

The float32 islands are the reference's: ``dt``, the decay, the states.
The intra-chunk contraction rounds its two operands to bfloat16 and
accumulates in float32, as the reference's ``preferred_element_type``
einsum does (here: bf16-rounded values contracted in float32).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def init_mamba_params(cfg: ModelConfig, gen: torch.Generator,
                      dtype=torch.float32) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    n, g = cfg.ssm_state, cfg.ssm_ngroups
    nh = di // cfg.ssm_headdim
    conv_dim = di + 2 * g * n
    dev = gen.device
    in_dim = 2 * di + 2 * g * n + nh  # z, x, B, C, dt
    return {
        "in_proj": L.dense_init(gen, d, in_dim, dtype),
        "conv_w": torch.randn((cfg.ssm_conv, conv_dim), generator=gen,
                              dtype=dtype, device=dev).mul_(0.1),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=dev)),
        "dt_bias": torch.zeros((nh,), dtype=dtype, device=dev),
        "d_skip": torch.ones((nh,), dtype=dtype, device=dev),
        "norm_w": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": L.dense_init(gen, di, d, dtype),
    }


def _split_in_proj(cfg: ModelConfig, zxbcdt: Tensor):
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
    nh = di // cfg.ssm_headdim
    return torch.split(zxbcdt, [di, di, g * n, g * n, nh], dim=-1)


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv1d.  x: (B, S, C); w: (K, C)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + s, :] * w[i]
    return out + b


def _segsum(x: Tensor) -> Tensor:
    """Lower-triangular segment sums: ``out[..., i, j] = Σ_{j<t<=i}
    x[..., t]`` (the log-decay matrix of SSD's intra-chunk term), -inf
    above the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, out, torch.full_like(out, -torch.inf))


def _rms_gate(y: Tensor, z: Tensor, params: dict, cfg: ModelConfig) -> Tensor:
    """Gated RMSNorm then the out projection."""
    y = L.rms_norm(y * F.silu(z), params["norm_w"], cfg.norm_eps)
    return y @ params["out_proj"].to(y.dtype)


def mamba_forward(params: dict, x_in: Tensor, cfg: ModelConfig,
                  return_state: bool = False):
    """Full-sequence SSD (train / prefill).  x_in: (B, S, D) → (B, S, D).

    B/C stay in their (…, G, N) group form and are contracted directly.
    With ``return_state`` also returns the decode cache after position S:
    ``{"conv": (B, K-1, conv_dim) raw conv inputs, "ssm": final state}``.
    """
    b, s, _ = x_in.shape
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
    hp = cfg.ssm_headdim
    nh = di // hp
    q = cfg.ssm_chunk
    dtype = x_in.dtype
    f32 = torch.float32

    zxbcdt = x_in @ params["in_proj"].to(dtype)
    z, x, b_mat, c_mat, dt = _split_in_proj(cfg, zxbcdt)
    xbc_raw = torch.cat([x, b_mat, c_mat], dim=-1)
    xbc = F.silu(_causal_conv(xbc_raw, params["conv_w"].to(dtype),
                              params["conv_b"].to(dtype)))
    x, b_mat, c_mat = torch.split(xbc, [di, g * n, g * n], dim=-1)

    dt = F.softplus(dt.to(f32) + params["dt_bias"])  # (B, S, nh)
    a = -torch.exp(params["a_log"])                  # (nh,)
    da = dt * a                                      # log-decay per step

    nc = (s + q - 1) // q
    pad = nc * q - s
    hb = nh // g  # heads per group

    def padq(t_):
        return F.pad(t_, (0, 0) * (t_.dim() - 2) + (0, pad))

    xh = padq(x).reshape(b, nc, q, g, hb, hp).to(f32)
    bm = padq(b_mat).reshape(b, nc, q, g, n).to(f32)
    cm = padq(c_mat).reshape(b, nc, q, g, n).to(f32)
    dac = padq(da).reshape(b, nc, q, g, hb)
    dtc = padq(dt).reshape(b, nc, q, g, hb)

    # intra-chunk (quadratic within a chunk): group-level C·B once, the
    # per-head decay in the contraction, dt folded into x
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cm, bm)            # (B,nc,G,Q,Q)
    lmat = torch.exp(_segsum(dac.permute(0, 1, 3, 4, 2)))      # (B,nc,G,hb,Q,Q)
    scores = (cb[:, :, :, None] * lmat).to(torch.bfloat16).to(f32)
    x_dt = xh * dtc[..., None]                                 # (B,nc,Q,G,hb,P)
    y_intra = torch.einsum("bcghqk,bckghp->bcqghp", scores,
                           x_dt.to(torch.bfloat16).to(f32))

    # chunk summary states
    cum = torch.cumsum(dac, dim=2)                             # (B,nc,Q,G,hb)
    total = cum[:, :, -1:]
    w_xh = x_dt * torch.exp(total - cum)[..., None]
    states = torch.einsum("bcqgn,bcqghp->bcghnp", bm, w_xh)    # (B,nc,G,hb,N,P)

    # inter-chunk recurrence: each chunk sees the state before it
    chunk_decay = torch.exp(total[:, :, 0])                    # (B,nc,G,hb)
    h = torch.zeros((b, g, hb, n, hp), dtype=f32, device=x_in.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, ..., None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                        # (B,nc,G,hb,N,P)

    y_inter = torch.einsum("bcqgn,bcghnp->bcqghp", cm, h_prev)
    y_inter = y_inter * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, nc * q, nh, hp)[:, :s]
    y = y + params["d_skip"].reshape(g * hb)[None, None, :, None] * \
        x.reshape(b, s, nh, hp).to(f32)
    y = y.reshape(b, s, di).to(dtype)
    out = _rms_gate(y, z, params, cfg)
    if not return_state:
        return out
    # decode cache: the last K-1 raw conv inputs, left-padded with zeros
    # for a stream shorter than that, and the final SSD state
    k_conv = cfg.ssm_conv
    tail = xbc_raw[:, max(s - (k_conv - 1), 0):]
    if s < k_conv - 1:
        tail = F.pad(tail, (0, 0, k_conv - 1 - s, 0))
    return out, {"conv": tail.to(dtype), "ssm": h.reshape(b, nh, n, hp)}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cuda") -> dict:
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
    nh = di // cfg.ssm_headdim
    conv_dim = di + 2 * g * n
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, n, di // nh), dtype=torch.float32,
                           device=device),
    }


def mamba_decode_step(params: dict, x_in: Tensor, cfg: ModelConfig,
                      cache: dict) -> Tensor:
    """One-token recurrent step.  x_in: (B, 1, D) → (B, 1, D); ``cache``
    (``{"conv", "ssm"}``, see :func:`init_mamba_cache`) is advanced in
    place."""
    b = x_in.shape[0]
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
    hp = cfg.ssm_headdim
    nh = di // hp
    dtype = x_in.dtype
    f32 = torch.float32

    zxbcdt = x_in[:, 0] @ params["in_proj"].to(dtype)        # (B, ·)
    z, x, b_mat, c_mat, dt = _split_in_proj(cfg, zxbcdt)
    xbc = torch.cat([x, b_mat, c_mat], dim=-1)                # (B, conv_dim)

    conv_hist = torch.cat([cache["conv"], xbc[:, None]], dim=1)  # (B, K, ·)
    w = params["conv_w"].to(dtype)
    out = (conv_hist * w[None]).sum(dim=1) + params["conv_b"].to(dtype)
    x, b_mat, c_mat = torch.split(F.silu(out), [di, g * n, g * n], dim=-1)

    dt = F.softplus(dt.to(f32) + params["dt_bias"])           # (B, nh)
    da = torch.exp(dt * -torch.exp(params["a_log"]))          # decay

    xh = x.reshape(b, nh, hp).to(f32)
    hpg = nh // g
    bh = torch.repeat_interleave(b_mat.reshape(b, g, n), hpg, dim=1)
    chh = torch.repeat_interleave(c_mat.reshape(b, g, n), hpg, dim=1)

    h = cache["ssm"] * da[:, :, None, None] + torch.einsum(
        "bhn,bhp,bh->bhnp", bh.to(f32), xh, dt)
    y = torch.einsum("bhn,bhnp->bhp", chh.to(f32), h)
    y = y + params["d_skip"][None, :, None] * xh
    y = y.reshape(b, di).to(dtype)
    cache["conv"].copy_(conv_hist[:, 1:])
    cache["ssm"].copy_(h)
    return _rms_gate(y, z, params, cfg)[:, None]

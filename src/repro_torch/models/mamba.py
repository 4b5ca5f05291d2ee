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

On a mesh the block is cut over ``model`` as the JAX package cuts it
(its rules put ``in_proj``'s columns, the conv's channels, the SSM heads
and the conv window over ``model``): each rank computes its heads and
channels in the stages below, and :func:`mamba_forward_split` /
:func:`mamba_decode_split` chain the same stages over simulated ranks on
one device.
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


# ---------------------------------------------------------------------------
# the block as stages.  On a mesh a rank holds its share of the heads
# (``nh_r = nh / tp``, heads ``[r·nh_r, (r+1)·nh_r)``) and of the channels
# (``distributed.sharding``'s part-wise cut: its heads' z, x and dt columns
# and one ``g·n / tp`` slice of B and of C), and runs
#   (a) its in_proj columns, the causal conv and SiLU on its channels;
#   (b) an all-gather over ``model`` of the conved B and C slices (every
#       head needs its whole group's);
#   (c) the SSD or the recurrence on its heads;
#   (d) the gated RMSNorm: its mean of squares over its channels summed
#       over ``model`` and divided by tp;
#   (e) its out_proj rows, summed over ``model``.
# At tp 1 the stages compute what the block computes whole, op for op.
# ---------------------------------------------------------------------------


def _local(cfg: ModelConfig, tp: int) -> Tuple[int, int, int]:
    """``(di_r, gn_r, nh_r)``: a rank's channels of x, of B (and of C),
    and its heads."""
    nh = cfg.d_inner // cfg.ssm_headdim
    return (cfg.d_inner // tp, cfg.ssm_ngroups * cfg.ssm_state // tp,
            nh // tp)


def _project(params: dict, x_in: Tensor, cfg: ModelConfig, tp: int):
    """(a) The rank's in_proj columns: ``(z, xbc_raw, dt)``, ``xbc_raw``
    the conv's raw inputs ``x | B | C`` on the rank's channels."""
    di, gn, nh = _local(cfg, tp)
    zxbcdt = x_in @ params["in_proj"].to(x_in.dtype)
    z, x, b_mat, c_mat, dt = torch.split(zxbcdt, [di, di, gn, gn, nh],
                                         dim=-1)
    return z, torch.cat([x, b_mat, c_mat], dim=-1), dt


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


def _conv_seq(params: dict, xbc_raw: Tensor) -> Tensor:
    """(a) The causal conv and SiLU over a sequence ``(B, S, ·)``."""
    dtype = xbc_raw.dtype
    return F.silu(_causal_conv(xbc_raw, params["conv_w"].to(dtype),
                               params["conv_b"].to(dtype)))


def _conv_step(params: dict, xbc_raw: Tensor, conv_cache: Tensor):
    """(a) One step of the conv and SiLU against the window ``(B, K-1,
    ·)``: ``(out, window + this step)``."""
    dtype = xbc_raw.dtype
    conv_hist = torch.cat([conv_cache, xbc_raw[:, None]], dim=1)  # (B, K, ·)
    out = ((conv_hist * params["conv_w"].to(dtype)[None]).sum(dim=1)
           + params["conv_b"].to(dtype))
    return F.silu(out), conv_hist


def _whole_bc(bc: Tensor, cfg: ModelConfig, tp: int):
    """(b) B and C ``(…, g·n)`` each from the ranks' conved ``B_r | C_r``
    slices concatenated in rank order ``(…, tp · 2 · gn_r)``."""
    gn = _local(cfg, tp)[1]
    parts = bc.unflatten(-1, (tp, 2, gn))
    return parts[..., 0, :].flatten(-2), parts[..., 1, :].flatten(-2)


def _heads(params: dict, b_mat: Tensor, c_mat: Tensor, cfg: ModelConfig,
           tp: int, rank: int):
    """The rank's heads as ``(g_r, hb_r)`` groups of heads, their B and C
    ``(…, g_r · n)``, and its slices of the per-head vectors."""
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    nh_r = _local(cfg, tp)[2]
    hb = cfg.d_inner // cfg.ssm_headdim // g
    if nh_r >= hb:  # whole groups
        g_r, hb_r = nh_r // hb, hb
        g0 = rank * g_r
    else:  # within one group
        g_r, hb_r = 1, nh_r
        g0 = rank * nh_r // hb
    lo = rank * nh_r

    def groups(m):
        return m.unflatten(-1, (g, n))[..., g0:g0 + g_r, :].flatten(-2)

    vec = {k: params[k][lo:lo + nh_r] for k in ("a_log", "dt_bias", "d_skip")}
    return g_r, hb_r, groups(b_mat), groups(c_mat), vec


def _ssd(params: dict, x: Tensor, b_mat: Tensor, c_mat: Tensor, dt: Tensor,
         cfg: ModelConfig, tp: int, rank: int):
    """(c) The chunked SSD on the rank's heads: ``(y (B, S, di_r), final
    state (B, nh_r, N, P))``."""
    b, s, _ = x.shape
    di, _, nh = _local(cfg, tp)
    n, hp, q = cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_chunk
    dtype = x.dtype
    f32 = torch.float32
    g, hb, b_mat, c_mat, vec = _heads(params, b_mat, c_mat, cfg, tp, rank)

    dt = F.softplus(dt.to(f32) + vec["dt_bias"])     # (B, S, nh)
    a = -torch.exp(vec["a_log"])                     # (nh,)
    da = dt * a                                      # log-decay per step

    nc = (s + q - 1) // q
    pad = nc * q - s

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
    h = torch.zeros((b, g, hb, n, hp), dtype=f32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, ..., None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                        # (B,nc,G,hb,N,P)

    y_inter = torch.einsum("bcqgn,bcghnp->bcqghp", cm, h_prev)
    y_inter = y_inter * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, nc * q, nh, hp)[:, :s]
    y = y + vec["d_skip"].reshape(g * hb)[None, None, :, None] * \
        x.reshape(b, s, nh, hp).to(f32)
    return y.reshape(b, s, di).to(dtype), h.reshape(b, nh, n, hp)


def _recur(params: dict, x: Tensor, b_mat: Tensor, c_mat: Tensor,
           dt: Tensor, ssm: Tensor, cfg: ModelConfig, tp: int, rank: int):
    """(c) One recurrent step on the rank's heads from the state ``ssm``
    ``(B, nh_r, N, P)``: ``(y (B, di_r), new state)``."""
    b = x.shape[0]
    di, _, nh = _local(cfg, tp)
    n, hp = cfg.ssm_state, cfg.ssm_headdim
    dtype = x.dtype
    f32 = torch.float32
    g, hpg, b_mat, c_mat, vec = _heads(params, b_mat, c_mat, cfg, tp, rank)

    dt = F.softplus(dt.to(f32) + vec["dt_bias"])              # (B, nh)
    da = torch.exp(dt * -torch.exp(vec["a_log"]))             # decay

    xh = x.reshape(b, nh, hp).to(f32)
    bh = torch.repeat_interleave(b_mat.reshape(b, g, n), hpg, dim=1)
    chh = torch.repeat_interleave(c_mat.reshape(b, g, n), hpg, dim=1)

    h = ssm * da[:, :, None, None] + torch.einsum(
        "bhn,bhp,bh->bhnp", bh.to(f32), xh, dt)
    y = torch.einsum("bhn,bhnp->bhp", chh.to(f32), h)
    y = y + vec["d_skip"][None, :, None] * xh
    return y.reshape(b, di).to(dtype), h


def _gate(y: Tensor, z: Tensor):
    """(d) The gated activations in float32 and their mean of squares over
    the rank's channels ``(…, 1)`` (at tp 1 ``rms_norm``'s own mean)."""
    xf = (y * F.silu(z)).to(torch.float32)
    return xf, torch.mean(xf * xf, dim=-1, keepdim=True)


def _norm_out(params: dict, xf: Tensor, ms: Tensor, cfg: ModelConfig,
              tp: int, rank: int, dtype) -> Tensor:
    """(d) + (e) The RMSNorm with the mean of squares summed over the
    ranks (``ms``), scaled by the rank's ``norm_w`` slice, then the rank's
    out_proj rows: its part of the block's output."""
    di = xf.shape[-1]
    w = params["norm_w"][rank * di:(rank + 1) * di]
    out = xf * torch.rsqrt(ms / tp + cfg.norm_eps)
    y = (out * (1.0 + w.to(torch.float32))).to(dtype)
    return y @ params["out_proj"].to(dtype)


def _tail(xbc_raw: Tensor, k_conv: int) -> Tensor:
    """The decode cache's conv window after a sequence: its last K-1 raw
    conv inputs, left-padded with zeros for a stream shorter than that."""
    s = xbc_raw.shape[1]
    tail = xbc_raw[:, max(s - (k_conv - 1), 0):]
    if s < k_conv - 1:
        tail = F.pad(tail, (0, 0, k_conv - 1 - s, 0))
    return tail


def _sum(parts) -> Tensor:
    """A sum in rank order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class _Join:
    """How the chain below joins its ranks' partial results, each given as
    a list in rank order: ``bc`` the conved ``B_r | C_r`` slices into the
    whole (b), ``ms`` the means of squares into their sum (d), ``out`` the
    out projections' partials into the block's output (e)."""

    def __init__(self, bc, ms, out):
        self.bc, self.ms, self.out = bc, ms, out


def _only(parts):
    return parts[0]


# the whole block on one device; the ranks simulated on one device (the
# all-gather a concatenation, the all-reduces sums in rank order)
_WHOLE = _Join(_only, _only, _only)
_SIMULATED = _Join(lambda parts: torch.cat(parts, dim=-1), _sum, _sum)


def _mesh_join(par) -> _Join:
    """The collectives over ``model`` of this rank on a mesh."""
    return _Join(lambda parts: par.share_tp(parts[0], parts[0].dim() - 1),
                 lambda parts: par.sum_tp(parts[0]),
                 lambda parts: par.reduce_tp(parts[0]))


def _finish(shards, ranks, yz, cfg: ModelConfig, tp: int, join: _Join,
            dtype) -> Tensor:
    """(d) + (e) over the ranks: the block's output from each rank's
    ``(y, z)``."""
    gates = [_gate(y, z) for y, z in yz]
    ms = join.ms([m for _, m in gates])
    return join.out([_norm_out(p, xf, ms, cfg, tp, r, dtype)
                     for p, r, (xf, _) in zip(shards, ranks, gates)])


def _forward(shards, ranks, x_in: Tensor, cfg: ModelConfig, tp: int,
             join: _Join):
    """The block over a sequence: each of ``ranks`` (param ``shards``) runs
    its stages, joined by ``join``.  Returns the output and each rank's
    decode cache after the sequence."""
    di = _local(cfg, tp)[0]
    proj = [_project(p, x_in, cfg, tp) for p in shards]
    xbc = [_conv_seq(p, raw) for p, (_, raw, _) in zip(shards, proj)]
    b_mat, c_mat = _whole_bc(join.bc([t[..., di:] for t in xbc]), cfg, tp)
    ssd = [_ssd(p, t[..., :di], b_mat, c_mat, dt, cfg, tp, r)
           for p, r, t, (_, _, dt) in zip(shards, ranks, xbc, proj)]
    out = _finish(shards, ranks, [(y, z) for (y, _), (z, _, _)
                                  in zip(ssd, proj)], cfg, tp, join,
                  x_in.dtype)
    return out, [{"conv": _tail(raw, cfg.ssm_conv).to(x_in.dtype), "ssm": h}
                 for (_, raw, _), (_, h) in zip(proj, ssd)]


def _decode(shards, ranks, x: Tensor, cfg: ModelConfig, tp: int, caches,
            join: _Join) -> Tensor:
    """One recurrent step of ``x`` ``(B, D)``, as :func:`_forward` runs
    the ranks; each rank's cache is advanced in place."""
    di = _local(cfg, tp)[0]
    proj = [_project(p, x, cfg, tp) for p in shards]
    conv = [_conv_step(p, raw, c["conv"])
            for p, (_, raw, _), c in zip(shards, proj, caches)]
    b_mat, c_mat = _whole_bc(join.bc([t[..., di:] for t, _ in conv]), cfg,
                             tp)
    rec = [_recur(p, t[..., :di], b_mat, c_mat, dt, c["ssm"], cfg, tp, r)
           for p, r, (t, _), (_, _, dt), c in zip(shards, ranks, conv, proj,
                                                 caches)]
    for c, (_, hist), (_, h) in zip(caches, conv, rec):
        c["conv"].copy_(hist[:, 1:])
        c["ssm"].copy_(h)
    return _finish(shards, ranks, [(y, z) for (y, _), (z, _, _)
                                   in zip(rec, proj)], cfg, tp, join, x.dtype)


def mamba_forward(params: dict, x_in: Tensor, cfg: ModelConfig,
                  return_state: bool = False, par=None):
    """Full-sequence SSD (train / prefill).  x_in: (B, S, D) → (B, S, D).

    B/C stay in their (…, G, N) group form and are contracted directly.
    With ``return_state`` also returns the decode cache after position S:
    ``{"conv": (B, K-1, conv_dim) raw conv inputs, "ssm": final state}``.
    On a mesh under ``par.mamba_tp`` ``params`` are the rank's part-wise
    shards and the state its heads and channels (the stages above, the
    collectives through ``par``); otherwise the block is computed whole.
    """
    if par is not None and par.mamba_tp:
        out, (state,) = _forward([params], [par.tp_rank],
                                 par.enter_tp(x_in), cfg, par.tp,
                                 _mesh_join(par))
    else:
        out, (state,) = _forward([params], [0], x_in, cfg, 1, _WHOLE)
    return (out, state) if return_state else out


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cuda", tp: int = 1) -> dict:
    """The decode state of ``batch`` rows; with ``tp`` one rank's share of
    it: its ``x_r | B_r | C_r`` conv channels and its heads."""
    di, gn, nh = _local(cfg, tp)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * gn),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, cfg.ssm_state, cfg.ssm_headdim),
                           dtype=torch.float32, device=device),
    }


def mamba_decode_step(params: dict, x_in: Tensor, cfg: ModelConfig,
                      cache: dict, par=None) -> Tensor:
    """One-token recurrent step.  x_in: (B, 1, D) → (B, 1, D); ``cache``
    (``{"conv", "ssm"}``, see :func:`init_mamba_cache`) is advanced in
    place.  On a mesh as :func:`mamba_forward`: under ``par.mamba_tp`` the
    cache is the rank's heads and channels."""
    if par is not None and par.mamba_tp:
        out = _decode([params], [par.tp_rank], par.enter_tp(x_in[:, 0]), cfg,
                      par.tp, [cache], _mesh_join(par))
    else:
        out = _decode([params], [0], x_in[:, 0], cfg, 1, [cache], _WHOLE)
    return out[:, None]


def mamba_forward_split(shards, x_in: Tensor, cfg: ModelConfig,
                        return_state: bool = False):
    """:func:`mamba_forward` over ``tp = len(shards)`` ranks' part-wise
    param shards (rank order), each rank's stages run in turn on one
    device with the collectives taken in rank order: the B/C all-gather a
    concatenation, the two all-reduces sums.  With ``return_state`` also
    returns each rank's decode cache (a list)."""
    tp = len(shards)
    out, states = _forward(shards, range(tp), x_in, cfg, tp, _SIMULATED)
    return (out, states) if return_state else out


def mamba_decode_split(shards, x_in: Tensor, cfg: ModelConfig,
                       caches) -> Tensor:
    """:func:`mamba_decode_step` over ``len(shards)`` ranks as
    :func:`mamba_forward_split` chains them; ``caches`` (each rank's, rank
    order) are advanced in place."""
    tp = len(shards)
    return _decode(shards, range(tp), x_in[:, 0], cfg, tp, caches,
                   _SIMULATED)[:, None]

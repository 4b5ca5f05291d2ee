"""Model assembly (PyTorch), as in ``repro.models.model``: embeddings →
layer stacks → head, for training and scoring (:func:`forward`), for
prefill and decode against the fixed-slot cache (:func:`prefill`,
:func:`decode_step`, the fixed-slot engine's path, every family) and for
chunked prefill, batched decode and speculative verify against the paged
KV cache (the uniform attention stacks: dense, MoE, VLM).

Params keep the JAX layout, so ``convert.params_from_jax`` carries any
family's tree across unchanged: a nested dict whose ``layers`` entries are
stacked over a leading layer axis ``(L, …)``; Jamba's hybrid stack is one
such stack per position of its period (``layers["pos{p}"]``, stacked over
the ``L / period`` groups); Whisper adds an ``encoder`` tree, cross-
attention in every decoder block and a learned decoder ``pos_embed``.  The
JAX ``lax.scan`` over layers is a Python loop over those stacks, and every
cache is updated **in place**.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.fused_verify import GLOBAL_WINDOW
from repro_torch.models import amm_mlp as AMM
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor

# Speculative-verify window implementations (see paged_verify_step):
# "scan" replays one exact paged_decode_step per window position (the
# oracle); "fused" is the layer-major window backed by
# kernels/fused_verify.py.
VERIFY_BACKENDS = ("scan", "fused")


def resolve_verify_backend(backend: str = "auto") -> str:
    """``auto`` → ``$REPRO_VERIFY_BACKEND`` if set, else ``fused``."""
    if backend == "auto":
        backend = os.environ.get("REPRO_VERIFY_BACKEND", "auto")
    if backend == "auto":
        backend = "fused"
    if backend not in VERIFY_BACKENDS:
        raise ValueError(
            f"verify backend must be 'auto' or one of {VERIFY_BACKENDS}, "
            f"got {backend!r}")
    return backend


def supports_paged(cfg: ModelConfig) -> bool:
    """Families with a paged KV decode path: uniform attention stacks
    (dense, MoE, VLM backbones).  SSM and hybrid caches are recurrent
    state; enc-dec keeps its cross-attention cache per slot.  Those
    families serve through the fixed-slot engine."""
    return not (cfg.family == "ssm" or cfg.is_hybrid or cfg.is_encdec)


def _check_paged(cfg: ModelConfig, what: str = "decode") -> None:
    if not supports_paged(cfg):
        raise ValueError(f"family {cfg.family!r} has no paged {what} path")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _dense_mlp(cfg: ModelConfig, gen: torch.Generator, dtype) -> dict:
    d = cfg.d_model
    return {"w_gate": L.dense_init(gen, d, cfg.d_ff, dtype),
            "w_up": L.dense_init(gen, d, cfg.d_ff, dtype),
            "w_down": L.dense_init(gen, cfg.d_ff, d, dtype)}


def _init_block(cfg: ModelConfig, gen: torch.Generator, layer_idx: int,
                dtype, serving: bool = False) -> dict:
    """One decoder block's params; ``layer_idx`` decides attention or Mamba
    and MoE or a dense (or, serving with ``cfg.amm.enabled``, LUT-MU)
    MLP."""
    d = cfg.d_model
    dev = gen.device
    p = {"ln1": torch.zeros((d,), dtype=dtype, device=dev)}
    if cfg.layer_is_attn(layer_idx):
        p["attn"] = A.init_attn_params(cfg, gen, dtype)
    else:
        p["mamba"] = MB.init_mamba_params(cfg, gen, dtype)
    if cfg.family == "ssm":
        return p  # mamba2: one mixer sub-block, no MLP
    p["ln2"] = torch.zeros((d,), dtype=dtype, device=dev)
    if cfg.layer_is_moe(layer_idx):
        p["moe"] = MOE.init_moe_params(cfg, gen, dtype)
    elif serving and cfg.amm.enabled and "mlp" in cfg.amm.targets:
        p["amm_mlp"] = AMM.init_amm_mlp_params(cfg, gen)
    else:
        p["mlp"] = _dense_mlp(cfg, gen, dtype)
    return p


def _init_encoder_block(cfg: ModelConfig, gen: torch.Generator,
                        dtype) -> dict:
    d, dev = cfg.d_model, gen.device
    return {"ln1": torch.zeros((d,), dtype=dtype, device=dev),
            "attn": A.init_attn_params(cfg, gen, dtype),
            "ln2": torch.zeros((d,), dtype=dtype, device=dev),
            "mlp": _dense_mlp(cfg, gen, dtype)}


def _init_decdec_block(cfg: ModelConfig, gen: torch.Generator, idx: int,
                       dtype) -> dict:
    """Whisper decoder block: self-attention, cross-attention, MLP."""
    p = _init_block(cfg, gen, idx, dtype)
    p["ln_cross"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                device=gen.device)
    p["cross"] = A.init_cross_attn_params(cfg, gen, dtype)
    return p


def _stack_into(dst: Optional[dict], src: dict, l: int, n: int) -> dict:
    """Write layer ``l``'s params into preallocated ``(n, …)`` stacks."""
    if dst is None:
        dst = {k: (_stack_into(None, v, l, n) if isinstance(v, dict) else
                   torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                               device=v.device))
               for k, v in src.items()}
    for k, v in src.items():
        if isinstance(v, dict):
            _stack_into(dst[k], v, l, n)
        else:
            dst[k][l].copy_(v)
    return dst


def _stacked(make_block: Callable[[], dict], n: int) -> dict:
    """``n`` blocks stacked on a leading axis, made one at a time (no 2x
    peak)."""
    out = None
    for l in range(n):
        out = _stack_into(out, make_block(), l, n)
    return out


def _cut_block(block: dict, shard: Callable, path: str) -> dict:
    """One layer of the stack at ``path`` through ``shard`` (see
    :func:`init_params`), each entry as a stack of one layer."""
    return {k: (_cut_block(v, shard, f"{path}/{k}") if isinstance(v, dict)
                else shard(f"{path}/{k}", v.unsqueeze(0)).squeeze(0))
            for k, v in block.items()}


def init_params(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
                serving: bool = False,
                shard: Optional[Callable[[str, Tensor], Tensor]] = None
                ) -> dict:
    """Random params of any family, made on ``gen``'s device, in the JAX
    layout; with ``serving`` and ``cfg.amm.enabled`` the dense MLPs are
    LUT-MU tables.  The draws differ from ``jax.random``'s: tests carry
    JAX params across with ``convert.params_from_jax`` instead.

    ``shard(path, leaf)``, where given, gets each leaf as it is drawn and
    returns the part kept (a rank's shard); a stacked leaf passes one
    layer at a time, as a stack of one.  The draws are the same, and a
    tree of shards never holds more than one whole leaf or layer."""
    d, dev = cfg.d_model, gen.device

    def top(path: str, t: Tensor) -> Tensor:
        return t if shard is None else shard(path, t)

    def stacked(make_block: Callable[[], dict], n: int, path: str) -> dict:
        if shard is None:
            return _stacked(make_block, n)
        return _stacked(lambda: _cut_block(make_block(), shard, path), n)

    params = {
        "embed": top("embed", L.embed_init(gen, cfg.vocab_size, d, dtype)),
        "final_norm": top("final_norm",
                          torch.zeros((d,), dtype=dtype, device=dev)),
        "lm_head": top("lm_head", L.dense_init(gen, d, cfg.vocab_size,
                                               dtype)),
    }
    if cfg.is_hybrid:
        period = cfg.attn_every
        params["layers"] = {
            f"pos{p}": stacked(lambda p=p: _init_block(cfg, gen, p, dtype,
                                                       serving),
                               cfg.num_layers // period, f"layers/pos{p}")
            for p in range(period)}
    elif cfg.is_encdec:
        params["encoder"] = {
            "layers": stacked(lambda: _init_encoder_block(cfg, gen, dtype),
                              cfg.encoder_layers, "encoder/layers"),
            "pos_embed": top("encoder/pos_embed", L.embed_init(
                gen, cfg.num_frontend_tokens, d, dtype)),
            "final_norm": top("encoder/final_norm",
                              torch.zeros((d,), dtype=dtype, device=dev)),
        }
        params["layers"] = stacked(
            lambda: _init_decdec_block(cfg, gen, 0, dtype), cfg.num_layers,
            "layers")
        params["pos_embed"] = top("pos_embed", L.embed_init(
            gen, cfg.max_seq_len, d, dtype))
    else:
        # uniform: every layer is built as layer ``moe_offset`` is
        params["layers"] = stacked(
            lambda: _init_block(cfg, gen, cfg.moe_offset, dtype, serving),
            cfg.num_layers, "layers")
    return params


def window_flags(cfg: ModelConfig) -> list:
    """(L,) per-layer attention window (sentinel 2**30 = global)."""
    return [cfg.sliding_window
            if cfg.sliding_window is not None and cfg.layer_is_local(i)
            else GLOBAL_WINDOW for i in range(cfg.num_layers)]


def layer_params(layers: dict, l: int) -> dict:
    """Layer ``l``'s params: views into the stacked ``(L, …)`` tensors."""
    return {k: layer_params(v, l) if isinstance(v, dict) else v[l]
            for k, v in layers.items()}


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype=torch.bfloat16, device="cuda") -> Dict[str, Tensor]:
    """Physical page pool: ``(L, P, page_size, n_kv, hd)`` per k/v; the
    caller includes its trash page in ``P``."""
    if not supports_paged(cfg):
        raise ValueError(f"family {cfg.family!r} has no paged KV layout")
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _mlp_out(lp: dict, mlp_in: Tensor, cfg: ModelConfig, cd,
             par=None) -> Tensor:
    """The per-block MLP shared by every path (MoE, LUT-MU or dense).  On a
    mesh the dense MLP is column-parallel (gate, up) then row-parallel
    (down): its input enters the TP region and its partials are summed over
    ``model``."""
    if "moe" in lp:
        return MOE.moe_apply(lp["moe"], mlp_in, cfg, par=par)
    if "amm_mlp" in lp:
        return AMM.amm_mlp_apply(lp["amm_mlp"], mlp_in, cfg, par=par)
    m = lp["mlp"]
    tp = par is not None and par.mlp_tp
    out = L.gated_mlp(par.enter_tp(mlp_in) if tp else mlp_in,
                      m["w_gate"].to(cd), m["w_up"].to(cd),
                      m["w_down"].to(cd), cfg.act)
    return par.reduce_tp(out) if tp else out


# ---------------------------------------------------------------------------
# on a mesh: the parallel context's reads (distributed/sharding.py)
# ---------------------------------------------------------------------------


def _layer(layers: dict, l: int, par=None, path: str = "layers") -> dict:
    """Layer ``l``'s params as the model reads them: views off a mesh, the
    gathered-at-use weights on one (``par``)."""
    if par is None:
        return layer_params(layers, l)
    return par.layer(layers, l, path)


def _acfg(cfg: ModelConfig, par) -> ModelConfig:
    """The config an attention block runs at (its local heads under
    attention TP)."""
    return cfg if par is None else par.attn_cfg(cfg)


def _attn_in(x: Tensor, par) -> Tensor:
    """An attention block's input entering its TP region (q, k, v are
    column-parallel) under attention TP."""
    if par is not None and par.attn_tp:
        return par.enter_tp(x)
    return x


def _attn_sum(out: Tensor, par) -> Tensor:
    """A row-parallel ``wo``'s partials summed over ``model``."""
    if par is not None and par.attn_tp:
        return par.reduce_tp(out)
    return out


def _embed(params: dict, tokens: Tensor, cd, par=None) -> Tensor:
    """Token embeddings; on a mesh a vocab-parallel lookup: each rank looks
    up the ids in its vocab shard (zeros elsewhere), summed over
    ``model``."""
    tokens = tokens.to(torch.int64)
    if par is None:
        return params["embed"].to(cd)[tokens]
    emb = par.leaf(params, "embed").to(cd)
    if not par.vocab_tp:
        return emb[tokens]
    n = emb.shape[0]
    ids = tokens - par.tp_rank * n
    ok = (ids >= 0) & (ids < n)
    h = emb[torch.clamp(ids, 0, n - 1)]
    h = torch.where(ok[..., None], h, torch.zeros((), dtype=cd,
                                                  device=h.device))
    return par.reduce_tp(h)


# ---------------------------------------------------------------------------
# forward (training / scoring)
# ---------------------------------------------------------------------------


def _block_apply(cfg: ModelConfig, lp: dict, h: Tensor, positions: Tensor,
                 window, layer_idx: int, mlp_tap=None, par=None,
                 path: str = "layers") -> Tensor:
    """One block over a full sequence (no cache): the mixer (attention or
    Mamba), then the MLP (MoE, LUT-MU or dense) unless the block has none;
    ``mlp_tap(layer_idx, mlp_in)`` sees each MLP input.  On a mesh
    (``par``) ``lp`` is the layer's local shards of the stack at ``path``,
    read (gathered) here, inside the block a remat recomputes."""
    if par is not None:
        lp = par.read(lp, path)
    if "mamba" in lp:
        h = h + MB.mamba_forward(lp["mamba"],
                                 L.rms_norm(h, lp["ln1"], cfg.norm_eps), cfg,
                                 par=par)
        if "ln2" not in lp:
            return h
    else:
        x = _attn_in(L.rms_norm(h, lp["ln1"], cfg.norm_eps), par)
        h = h + _attn_sum(A.attention(lp["attn"], x, _acfg(cfg, par),
                                      positions=positions, window=window),
                          par)
    if "ln_cross" in lp:
        return h  # the enc-dec decoder applies cross-attention itself
    mlp_in = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    if mlp_tap is not None:
        mlp_tap(layer_idx, mlp_in)
    return h + _mlp_out(lp, mlp_in, cfg, h.dtype, par)


def _layer_views(layers: dict, n: int) -> list:
    """The stacked ``(L, …)`` params as L per-layer dicts of views, made by
    one ``unbind`` per stack (one backward node each, not L)."""
    per = [dict() for _ in range(n)]
    for k, v in layers.items():
        parts = (_layer_views(v, n) if isinstance(v, dict)
                 else torch.unbind(v, 0))
        for l in range(n):
            per[l][k] = parts[l]
    return per


def _apply(remat: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward pass when ``remat``
    (``torch.utils.checkpoint``, non-reentrant)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _run_uniform_stack(cfg: ModelConfig, layers: dict, h: Tensor,
                       positions: Tensor, remat: bool, par=None) -> Tensor:
    for l, (lp, win) in enumerate(zip(_layer_views(layers, cfg.num_layers),
                                      window_flags(cfg))):
        h = _apply(remat, _block_apply, cfg, lp, h, positions, win, l, None,
                   par)
    return h


def _run_hybrid_stack(cfg: ModelConfig, layers: dict, h: Tensor,
                      positions: Tensor, remat: bool, par=None) -> Tensor:
    """Jamba: the period's positions in order, group after group; each
    layer recomputed on its own in the backward pass when ``remat``."""
    period = cfg.attn_every
    n_groups = cfg.num_layers // period
    views = {f"pos{p}": _layer_views(layers[f"pos{p}"], n_groups)
             for p in range(period)}
    for g in range(n_groups):
        for p in range(period):
            h = _apply(remat, _block_apply, cfg, views[f"pos{p}"][g], h,
                       positions, GLOBAL_WINDOW, p, None, par,
                       f"layers/pos{p}")
    return h


def _encoder_block(cfg: ModelConfig, lp: dict, h: Tensor,
                   par=None) -> Tensor:
    if par is not None:
        lp = par.read(lp, "encoder/layers")
    t = h.shape[1]
    h = h + _attn_sum(A.attention(
        lp["attn"], _attn_in(L.rms_norm(h, lp["ln1"], cfg.norm_eps), par),
        _acfg(cfg, par), positions=torch.arange(t, device=h.device)[None],
        causal=False, window=None), par)
    return h + _mlp_out(lp, L.rms_norm(h, lp["ln2"], cfg.norm_eps), cfg,
                        h.dtype, par)


def _run_encoder(cfg: ModelConfig, enc_params: dict, frames: Tensor,
                 remat: bool, par=None) -> Tensor:
    """Whisper's bidirectional encoder over the frame embeddings
    ``(B, T, D)``."""
    t = frames.shape[1]
    pos_embed = (enc_params["pos_embed"] if par is None else
                 par.leaf({"encoder": enc_params}, "encoder/pos_embed"))
    h = frames + pos_embed[:t].to(frames.dtype)
    for lp in _layer_views(enc_params["layers"], cfg.encoder_layers):
        h = _apply(remat, _encoder_block, cfg, lp, h, par)
    return L.rms_norm(h, enc_params["final_norm"], cfg.norm_eps)


def _decdec_block(cfg: ModelConfig, lp: dict, h: Tensor, enc: Tensor,
                  positions: Tensor, par=None) -> Tensor:
    if par is not None:
        lp = par.read(lp, "layers")
    acfg = _acfg(cfg, par)
    h = h + _attn_sum(A.attention(
        lp["attn"], _attn_in(L.rms_norm(h, lp["ln1"], cfg.norm_eps), par),
        acfg, positions=positions, window=None), par)
    h = h + _attn_sum(A.cross_attention(
        lp["cross"], _attn_in(L.rms_norm(h, lp["ln_cross"], cfg.norm_eps),
                              par), _attn_in(enc, par), acfg), par)
    return h + _mlp_out(lp, L.rms_norm(h, lp["ln2"], cfg.norm_eps), cfg,
                        h.dtype, par)


def _run_encdec_decoder(cfg: ModelConfig, layers: dict, h: Tensor,
                        enc: Tensor, positions: Tensor,
                        remat: bool, par=None) -> Tensor:
    for lp in _layer_views(layers, cfg.num_layers):
        h = _apply(remat, _decdec_block, cfg, lp, h, enc, positions, par)
    return h


def forward(params: dict, tokens: Tensor, cfg: ModelConfig, *,
            remat: bool = True, compute_dtype=torch.bfloat16,
            extra_embeds: Optional[Tensor] = None, par=None) -> Tensor:
    """tokens (B, S) [+ frontend embeddings (B, T, D)] → logits (B, S, V)
    float32, differentiable: the training and scoring forward of every
    family.  For enc-dec (Whisper) ``extra_embeds`` are the encoder's input
    frames; for a VLM they are patch embeddings prepended to the tokens
    (logits over the text positions only).  ``remat`` recomputes each layer
    in the backward pass instead of keeping its activations.

    On a mesh (``par``, a ``distributed.sharding.ParallelContext``) it is
    one rank's share of the training forward: ``params`` are the rank's
    shards, the rows its data rank's, and the logits those rows' over the
    whole vocabulary (gathered over ``model``, never over ``data``).  Each
    layer's weights are gathered inside its block, so a remat gathers them
    again, every rank in the same order."""
    cd = compute_dtype
    tokens = tokens.to(torch.int64)
    b, s = tokens.shape
    dev = tokens.device
    h = _embed(params, tokens, cd, par)
    if cfg.is_encdec:
        if extra_embeds is None:
            raise ValueError("an enc-dec model needs its frame embeddings "
                             "(extra_embeds)")
        enc = _run_encoder(cfg, params["encoder"], extra_embeds.to(cd), remat,
                           par)
        pos_embed = (params["pos_embed"] if par is None
                     else par.leaf(params, "pos_embed"))
        h = h + pos_embed[:s].to(cd)
        positions = torch.arange(s, device=dev).expand(b, s)
        h = _run_encdec_decoder(cfg, params["layers"], h, enc, positions,
                                remat, par)
    else:
        if extra_embeds is not None:  # VLM: prepend the patch embeddings
            h = torch.cat([extra_embeds.to(cd), h], dim=1)
        s_tot = h.shape[1]
        positions = torch.arange(s_tot, device=dev).expand(b, s_tot)
        run = _run_hybrid_stack if cfg.is_hybrid else _run_uniform_stack
        h = run(cfg, params["layers"], h, positions, remat, par)
        if extra_embeds is not None:
            h = h[:, extra_embeds.shape[1]:]
    return _logits(params, h, cfg, cd, par)


@torch.inference_mode()
def capture_mlp_inputs(params: dict, tokens, cfg: ModelConfig, *,
                       compute_dtype=torch.float32) -> list:
    """Run the forward pass layer by layer, recording each layer's MLP
    input: a list of ``(B·S, D)`` activations in layer order — what the
    LUT-MU MLP sees in serving.  ``tokens``: (B, S) ints.  Uniform
    attention stacks only (the families the LUT-MU MLP targets)."""
    if cfg.is_hybrid or cfg.is_encdec or cfg.family == "ssm":
        raise ValueError(
            f"MLP-input capture supports uniform attention stacks, "
            f"not family {cfg.family!r}")
    cd = compute_dtype
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device).to(torch.int64)
    b, s = tokens.shape
    h = embed.to(cd)[tokens]
    positions = torch.arange(s, device=embed.device).expand(b, s)
    captured: list = []

    def tap(layer_idx, mlp_in):
        captured.append(mlp_in.reshape(-1, cfg.d_model))

    for l, win in enumerate(window_flags(cfg)):
        h = _block_apply(cfg, layer_params(params["layers"], l), h, positions,
                         win, l, mlp_tap=tap)
    return captured


def _logits(params: dict, h: Tensor, cfg: ModelConfig, cd,
            par=None) -> Tensor:
    """Final norm and logits (float32) of the rows ``h`` holds; on a mesh
    the vocab-parallel head's input enters its TP region and the logits are
    gathered over ``model``."""
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    if par is None:
        return (h @ params["lm_head"].to(cd)).to(torch.float32)
    if not par.vocab_tp:
        return (h @ par.leaf(params, "lm_head").to(cd)).to(torch.float32)
    logits = (par.enter_tp(h) @ par.leaf(params, "lm_head").to(cd)).to(
        torch.float32)
    return par.gather_tp(logits, -1)


def _head(params: dict, h: Tensor, cfg: ModelConfig, cd, par=None,
          batch: Optional[int] = None) -> Tensor:
    """The serving head: :func:`_logits`, and on a mesh the rows of a
    ``batch`` split over ``data`` gathered over ``data``, so every rank
    samples from the whole vocabulary of every row, as on one device."""
    logits = _logits(params, h, cfg, cd, par)
    if par is None:
        return logits
    return par.gather_rows(logits, h.shape[0] if batch is None else batch)


# ---------------------------------------------------------------------------
# serving against the fixed-slot cache: init, prefill, decode (every family)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """The fixed-slot cache of ``batch`` rows: attention K/V ``(L, B,
    max_len, n_kv, hd)``, Mamba state ``{"conv", "ssm"}`` per layer; the
    hybrid stack one of these per position of its period (``(L / period,
    B, …)``); enc-dec adds the cross-attention K/V ``(L, B, T, n_kv, hd)``
    and the encoder states ``(B, T, D)``.  On a mesh a rank holds its
    part of this tree, placed by ``ParallelContext.place_cache``."""
    hd, nkv = cfg.resolved_head_dim, cfg.num_kv_heads

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def attn_cache(n_layers):
        return {"k": zeros(n_layers, batch, max_len, nkv, hd),
                "v": zeros(n_layers, batch, max_len, nkv, hd)}

    def mamba_cache(n_layers):
        mc = MB.init_mamba_cache(cfg, batch, dtype, device)
        return {"mamba": {k: v[None].repeat((n_layers,) + (1,) * v.dim())
                          for k, v in mc.items()}}

    if cfg.family == "ssm":
        return mamba_cache(cfg.num_layers)
    if cfg.is_hybrid:
        n_groups = cfg.num_layers // cfg.attn_every
        return {f"pos{p}": (attn_cache(n_groups) if cfg.layer_is_attn(p)
                            else mamba_cache(n_groups))
                for p in range(cfg.attn_every)}
    if cfg.is_encdec:
        c = attn_cache(cfg.num_layers)
        t = cfg.num_frontend_tokens
        c["cross_k"] = zeros(cfg.num_layers, batch, t, nkv, hd)
        c["cross_v"] = zeros(cfg.num_layers, batch, t, nkv, hd)
        c["enc"] = zeros(batch, t, cfg.d_model)
        return c
    return attn_cache(cfg.num_layers)


def _seq_split(par, path: str):
    """The sequence cut of the placed cache leaf at ``path`` on a mesh
    (``ParallelContext.seq_split``), ``None`` off one."""
    return None if par is None else par.seq_split(path)


def _decode_block(cfg: ModelConfig, lp: dict, h: Tensor, cache: dict,
                  pos: Tensor, window, cd, par=None,
                  path: str = "k") -> Tensor:
    """One uniform or hybrid block of a decode step; ``cache`` is this
    layer's slice (``{"k", "v"}`` or ``{"mamba": …}``), written in
    place; ``path`` names its K leaf in the cache tree."""
    x = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    if "mamba" in lp:
        h = h + MB.mamba_decode_step(lp["mamba"], x, cfg, cache["mamba"],
                                     par)
        if "ln2" not in lp:
            return h
    else:
        h = h + _attn_sum(A.decode_step(lp["attn"], x, _acfg(cfg, par),
                                        cache["k"], cache["v"], pos, window,
                                        _seq_split(par, path), par), par)
    return h + _mlp_out(lp, L.rms_norm(h, lp["ln2"], cfg.norm_eps), cfg, cd,
                        par)


def _slice(tree: dict, i: int) -> dict:
    """Entry ``i`` of every stacked leaf of a cache tree (views)."""
    return {k: _slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


@torch.inference_mode()
def decode_step(params: dict, token: Tensor, pos: Tensor, cache: dict,
                cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
                par=None) -> Tensor:
    """One decode step of any family against the fixed-slot cache.

    token: (B, 1) int; pos: (B,) per-row positions (tokens so far), or one
    position for every row; cache: :func:`init_cache`'s tree, updated in
    place.  Returns logits (B, 1, V) float32.

    On a mesh (``par``) the inputs are the whole batch and ``cache`` this
    rank's part of it, placed by ``ParallelContext.place_cache`` (JAX's
    ``cache_shardings``): the rows over ``data`` when they divide, and an
    attention cache whose sequence is cut is read by the partial softmax
    over its group.  The logits are the whole batch's.
    """
    cd = compute_dtype
    b_all = token.shape[0]
    if par is not None:
        token = par.local_rows(token)
        if pos.dim() and pos.numel() == b_all:
            pos = par.local_rows(pos.reshape(-1))
    b = token.shape[0]
    h = _embed(params, token, cd, par)  # (B, 1, D)
    if cfg.is_hybrid:
        period = cfg.attn_every
        for g in range(cfg.num_layers // period):
            for p in range(period):
                key = f"pos{p}"
                h = _decode_block(cfg, _layer(params["layers"][key], g, par,
                                              f"layers/{key}"),
                                  h, _slice(cache[key], g), pos, None, cd,
                                  par, f"{key}/k")
    elif cfg.is_encdec:
        acfg = _acfg(cfg, par)
        pos_b = pos.to(torch.int64).reshape(-1).expand(b)
        pos_embed = (params["pos_embed"] if par is None
                     else par.leaf(params, "pos_embed"))
        h = h + pos_embed[pos_b][:, None].to(cd)
        for l in range(cfg.num_layers):
            lp = _layer(params["layers"], l, par)
            h = h + _attn_sum(A.decode_step(
                lp["attn"], L.rms_norm(h, lp["ln1"], cfg.norm_eps), acfg,
                cache["k"][l], cache["v"][l], pos, None,
                _seq_split(par, "k"), par), par)
            h = h + _attn_sum(A.cross_decode(
                lp["cross"], L.rms_norm(h, lp["ln_cross"], cfg.norm_eps),
                cache["cross_k"][l], cache["cross_v"][l], acfg,
                _seq_split(par, "cross_k"), par), par)
            h = h + _mlp_out(lp, L.rms_norm(h, lp["ln2"], cfg.norm_eps), cfg,
                             cd, par)
    else:  # uniform: attention (dense, MoE, VLM) or Mamba (ssm)
        for l, win in enumerate(window_flags(cfg)):
            h = _decode_block(cfg, _layer(params["layers"], l, par), h,
                              _slice(cache, l), pos, win, cd, par)
    return _head(params, h, cfg, cd, par, b_all)


def _stack_caches(caches: list) -> dict:
    """Per-layer cache trees → one tree stacked on a leading layer axis."""
    first = caches[0]
    return {k: (_stack_caches([c[k] for c in caches])
                if isinstance(first[k], dict)
                else torch.stack([c[k] for c in caches]))
            for k in first}


def _prefill_block(cfg: ModelConfig, lp: dict, h: Tensor, positions: Tensor,
                   window, max_len: int, cd, par=None) -> Tuple[Tensor, dict]:
    """One uniform or hybrid block over the prompt; returns the new hidden
    states and this layer's cache."""
    x = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    if "mamba" in lp:
        out, st = MB.mamba_forward(lp["mamba"], x, cfg, return_state=True,
                                   par=par)
        h, cache = h + out, {"mamba": st}
        if "ln2" not in lp:
            return h, cache
    else:
        out, (k, v) = A.prefill_with_cache(lp["attn"], x, _acfg(cfg, par),
                                           positions, window, max_len)
        h, cache = h + _attn_sum(out, par), {"k": k, "v": v}
    h = h + _mlp_out(lp, L.rms_norm(h, lp["ln2"], cfg.norm_eps), cfg, cd,
                     par)
    return h, cache


@torch.inference_mode()
def prefill(params: dict, tokens: Tensor, cfg: ModelConfig, max_len: int, *,
            extra_embeds: Optional[Tensor] = None,
            compute_dtype=torch.bfloat16, par=None) -> Tuple[Tensor, dict]:
    """Process whole prompts: ``(logits (B, 1, V) float32 at the last
    position, cache)``, the cache shaped as :func:`init_cache`'s for B rows
    and ``max_len`` positions.  SSM and hybrid layers run the chunked SSD
    and keep its final state; ``extra_embeds`` are Whisper's frames or a
    VLM's prepended patch embeddings (which then take the first cache
    positions).

    On a mesh (``par``) ``tokens`` (and ``extra_embeds``) are the whole
    batch: a rank computes its data rank's rows when they split over
    ``data`` (as :func:`decode_step` does), else every row (an admission's
    one prompt).  The logits are the whole batch's; the cache holds the
    rows the rank computed in the compute layout (local kv heads under
    attention TP, the Mamba state's local heads and conv channels under
    Mamba TP, every other dim whole).
    """
    cd = compute_dtype
    tokens = tokens.to(torch.int64)
    b_all = tokens.shape[0]
    if par is not None:
        tokens = par.local_rows(tokens)
        if extra_embeds is not None:
            extra_embeds = par.local_rows(extra_embeds)
    b, s = tokens.shape
    dev = tokens.device
    acfg = _acfg(cfg, par)
    h = _embed(params, tokens, cd, par)
    positions = torch.arange(s, device=dev).expand(b, s)
    if cfg.is_encdec:
        if extra_embeds is None:
            raise ValueError("an enc-dec model needs its frame embeddings "
                             "(extra_embeds)")
        enc = _run_encoder(cfg, params["encoder"], extra_embeds.to(cd),
                           remat=False, par=par)
        pos_embed = (params["pos_embed"] if par is None
                     else par.leaf(params, "pos_embed"))
        h = h + pos_embed[:s].to(cd)
        nkv, hd = acfg.num_kv_heads, cfg.resolved_head_dim
        per = []
        for l in range(cfg.num_layers):
            lp = _layer(params["layers"], l, par)
            out, (k, v) = A.prefill_with_cache(
                lp["attn"], L.rms_norm(h, lp["ln1"], cfg.norm_eps), acfg,
                positions, None, max_len)
            h = h + _attn_sum(out, par)
            h = h + _attn_sum(A.cross_attention(
                lp["cross"], L.rms_norm(h, lp["ln_cross"], cfg.norm_eps),
                enc, acfg), par)
            xk = (enc @ lp["cross"]["wk"].to(cd)).reshape(b, -1, nkv, hd)
            xv = (enc @ lp["cross"]["wv"].to(cd)).reshape(b, -1, nkv, hd)
            h = h + _mlp_out(lp, L.rms_norm(h, lp["ln2"], cfg.norm_eps), cfg,
                             cd, par)
            per.append({"k": k, "v": v, "cross_k": xk, "cross_v": xv})
        cache = dict(_stack_caches(per), enc=enc)
    elif cfg.is_hybrid:
        period = cfg.attn_every
        per = {f"pos{p}": [] for p in range(period)}
        for g in range(cfg.num_layers // period):
            for p in range(period):
                key = f"pos{p}"
                h, c = _prefill_block(cfg, _layer(params["layers"][key], g,
                                                  par, f"layers/{key}"),
                                      h, positions, None, max_len, cd, par)
                per[key].append(c)
        cache = {k: _stack_caches(v) for k, v in per.items()}
    else:
        if extra_embeds is not None:  # VLM: prepend the patch embeddings
            h = torch.cat([extra_embeds.to(cd), h], dim=1)
            positions = torch.arange(h.shape[1], device=dev).expand(
                b, h.shape[1])
        per = []
        for l, win in enumerate(window_flags(cfg)):
            h, c = _prefill_block(cfg, _layer(params["layers"], l, par), h,
                                  positions, win, max_len, cd, par)
            per.append(c)
        cache = _stack_caches(per)
    return _head(params, h[:, -1:], cfg, cd, par, b_all), cache


# ---------------------------------------------------------------------------
# serving against the paged KV cache (uniform attention stacks)
# ---------------------------------------------------------------------------


@torch.inference_mode()
def paged_decode_step(params: dict, token: Tensor, pos: Tensor,
                      page_table: Tensor, cache: Dict[str, Tensor],
                      cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
                      write_ok: Optional[Tensor] = None,
                      par=None) -> Tensor:
    """One decode step against the paged KV cache.

    token: (B, 1) int; pos: (B,) per-row write positions; page_table:
    (B, max_pages) int32 (rows without a request point at the trash page);
    cache: ``{"k","v"}`` of (L, P, page_size, n_kv, hd), updated in place.
    Returns logits (B, 1, V) float32.

    On a mesh (``par``) this rank computes its data rank's rows and
    returns the whole batch's logits; with more than one data rank its
    pages are its shard of the pool (``attention.paged_decode_step``).
    """
    _check_paged(cfg, "decode")
    cd = compute_dtype
    b_all = token.shape[0]
    acfg = _acfg(cfg, par)
    if par is not None:
        token = par.local_rows(token)
    h = _embed(params, token, cd, par)  # (B, 1, D)
    for l, win in enumerate(window_flags(cfg)):
        lp = _layer(params["layers"], l, par)
        h = h + _attn_sum(A.paged_decode_step(
            lp["attn"], L.rms_norm(h, lp["ln1"], cfg.norm_eps), acfg,
            cache["k"][l], cache["v"][l], page_table, pos, win,
            write_ok=write_ok, par=par), par)
        h = h + _mlp_out(lp, L.rms_norm(h, lp["ln2"], cfg.norm_eps), cfg, cd,
                         par)
    return _head(params, h, cfg, cd, par, b_all)


@torch.inference_mode()
def paged_prefill_chunk(params: dict, tokens: Tensor, start, n_valid,
                        page_row: Tensor, cache: Dict[str, Tensor],
                        cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
                        par=None) -> Tensor:
    """One chunk of a single request's prefill against the paged cache.

    tokens: (1, cs) right-padded to the engine's chunk width; start /
    n_valid: tokens already prefilled / real tokens in this chunk, ints or
    0-d integer tensors on the tokens' device (as in JAX, one program then
    serves every chunk: nothing here reads them on the host); page_row:
    (max_pages,) int32.  The cache is updated in place.  Returns logits
    (1, 1, V) float32 at the chunk's last valid position (position 0 when
    ``n_valid`` is 0, a chunk that writes only the trash page).  On a mesh
    (``par``) every rank computes the chunk; with more than one data rank
    each writes the pages it holds and reads the request's view from
    every rank's (``attention.paged_prefill_chunk``).
    """
    _check_paged(cfg, "prefill")
    cd = compute_dtype
    acfg = _acfg(cfg, par)
    start = torch.as_tensor(start, device=tokens.device)
    n_valid = torch.as_tensor(n_valid, device=tokens.device)
    last = torch.clamp(n_valid.to(torch.int64) - 1, min=0).reshape(1)
    h = _embed(params, tokens, cd, par)
    for l, win in enumerate(window_flags(cfg)):
        lp = _layer(params["layers"], l, par)
        h = h + _attn_sum(A.paged_prefill_chunk(
            lp["attn"], L.rms_norm(h, lp["ln1"], cfg.norm_eps), acfg, start,
            n_valid, cache["k"][l], cache["v"][l], page_row, win, par), par)
        h = h + _mlp_out(lp, L.rms_norm(h, lp["ln2"], cfg.norm_eps), cfg, cd,
                         par)
    return _head(params, h.index_select(1, last), cfg, cd, par)


@torch.inference_mode()
def paged_verify_step(params: dict, tokens: Tensor, pos: Tensor,
                      n_valid: Tensor, page_table: Tensor,
                      cache: Dict[str, Tensor], cfg: ModelConfig, *,
                      compute_dtype=torch.bfloat16, backend: str = "auto"
                      ) -> Tensor:
    """Multi-token target step: per-position logits for a whole verify
    window.

    Row ``b`` feeds ``tokens[b]`` (its last emitted token, then the draft
    proposals) at cache positions ``pos[b] .. pos[b]+W-1``.  tokens: (B, W)
    int; pos / n_valid: (B,) int — window slots past ``n_valid`` write to
    the trash page and their logits are don't-cares.  The cache is updated
    in place.  Returns logits (B, W, V) float32: ``argmax(logits[b, j])``
    is the token the target emits after ``tokens[b, :j+1]``.

    ``backend`` (``auto`` honours ``$REPRO_VERIFY_BACKEND``, then
    ``fused``): ``scan`` replays the exact :func:`paged_decode_step` per
    window position; ``fused`` runs layer-major with one verify-window
    attention per layer (the CUDA kernel on CUDA tensors) and every other
    op at the oracle's per-token shapes — on the CPU the two are bitwise
    equal.
    """
    if resolve_verify_backend(backend) == "fused":
        return _paged_verify_step_fused(
            params, tokens, pos, n_valid, page_table, cache, cfg,
            compute_dtype=compute_dtype)
    logits = [paged_decode_step(params, tokens[:, off:off + 1], pos + off,
                                page_table, cache, cfg,
                                compute_dtype=compute_dtype,
                                write_ok=off < n_valid)
              for off in range(tokens.shape[1])]
    return torch.cat(logits, dim=1)


def _paged_verify_step_fused(params: dict, tokens: Tensor, pos: Tensor,
                             n_valid: Tensor, page_table: Tensor,
                             cache: Dict[str, Tensor], cfg: ModelConfig, *,
                             compute_dtype=torch.bfloat16) -> Tensor:
    """Layer-major verify window (see :func:`paged_verify_step`): per layer
    ``attention.paged_verify_window``, then the MLP and finally the head
    per token at ``(B, 1, D)``."""
    _check_paged(cfg, "decode")
    cd = compute_dtype
    w = tokens.shape[1]
    h = params["embed"].to(cd)[tokens.to(torch.int64)]  # (B, W, D)
    for l, win in enumerate(window_flags(cfg)):
        lp = layer_params(params["layers"], l)
        h = h + A.paged_verify_window(
            lp["attn"], L.rms_norm(h, lp["ln1"], cfg.norm_eps), cfg,
            cache["k"][l], cache["v"][l], page_table, pos, n_valid, win)
        mlp_in = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
        h = h + torch.cat([_mlp_out(lp, mlp_in[:, j:j + 1].contiguous(),
                                    cfg, cd) for j in range(w)], dim=1)
    return torch.cat([_head(params, h[:, j:j + 1].contiguous(), cfg, cd)
                      for j in range(w)], dim=1)


def _greedy(logits: Tensor, off: int) -> Tuple[Tensor, None]:
    return torch.argmax(logits, dim=-1).to(torch.int32), None


@torch.inference_mode()
def paged_draft_loop(params: dict, token: Tensor, pos: Tensor,
                     n_valid: Tensor, page_table: Tensor,
                     cache: Dict[str, Tensor], cfg: ModelConfig, k: int, *,
                     sample: Optional[Callable] = None,
                     compute_dtype=torch.bfloat16
                     ) -> Tuple[Tensor, Optional[Tensor]]:
    """``k`` draft-model decode steps over the whole decode batch.

    Row ``b`` starts from ``token[b]`` (B, 1) at cache position ``pos[b]``
    and proposes ``k`` tokens, writing the draft's KV in place (to the
    trash page past the row's ``n_valid`` window).  ``k+1`` steps run: the
    last one is write-only, so the KV of the last proposal is in the draft
    cache too — without it a fully accepted window would leave a hole
    there, and an identical draft would stop accepting everything.

    ``sample``: ``(logits (B, V), off) -> (next (B,) int32, probs or
    None)``; the default is greedy argmax (first index on ties) and
    reports no distribution (the greedy round needs none).

    Returns ``(draft (B, k) int32, q (B, k, V) or None)``.
    """
    sample = _greedy if sample is None else sample
    tok, toks, qs = token, [], []
    for off in range(k + 1):
        logits = paged_decode_step(params, tok, pos + off, page_table, cache,
                                   cfg, compute_dtype=compute_dtype,
                                   write_ok=off < n_valid)
        if off == k:
            break  # write-only step: its proposal would be discarded
        nxt, q = sample(logits[:, 0], off)
        toks.append(nxt)
        qs.append(q)
        tok = nxt[:, None]
    q_probs = None if any(q is None for q in qs) else torch.stack(qs, dim=1)
    return torch.stack(toks, dim=1), q_probs

"""The paged serving path of a uniform dense LM (PyTorch), as in
``repro.models.model``: embeddings → layer stack → head, for chunked
prefill and batched decode against the paged KV cache.

Params keep the JAX layout: a nested dict whose ``layers`` entries are
stacked over a leading layer axis ``(L, …)``.  The JAX ``lax.scan`` over
layers is a Python loop over those stacks, and the paged cache
``{"k","v"}`` of ``(L, P, page_size, n_kv, hd)`` is updated **in place**.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.fused_verify import GLOBAL_WINDOW
from repro_torch.models import amm_mlp as AMM
from repro_torch.models import attention as A
from repro_torch.models import layers as L
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
    """Uniform attention stacks have a paged KV path; SSM, hybrid and
    enc-dec families do not."""
    return not (cfg.family == "ssm" or cfg.is_hybrid or cfg.is_encdec)


def _check_uniform_dense(cfg: ModelConfig) -> None:
    if not supports_paged(cfg) or cfg.is_moe:
        raise NotImplementedError(
            f"the port serves uniform dense stacks only, not family "
            f"{cfg.family!r} (ROADMAP A10)")


def _init_block(cfg: ModelConfig, gen: torch.Generator, dtype,
                serving: bool) -> dict:
    d = cfg.d_model
    dev = gen.device
    p = {"ln1": torch.zeros((d,), dtype=dtype, device=dev),
         "attn": A.init_attn_params(cfg, gen, dtype),
         "ln2": torch.zeros((d,), dtype=dtype, device=dev)}
    if serving and cfg.amm.enabled and "mlp" in cfg.amm.targets:
        p["amm_mlp"] = AMM.init_amm_mlp_params(cfg, gen)
    else:
        p["mlp"] = {
            "w_gate": L.dense_init(gen, d, cfg.d_ff, dtype),
            "w_up": L.dense_init(gen, d, cfg.d_ff, dtype),
            "w_down": L.dense_init(gen, cfg.d_ff, d, dtype),
        }
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


def init_params(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
                serving: bool = False) -> dict:
    """Random params of a uniform dense stack, made on ``gen``'s device;
    with ``serving`` and ``cfg.amm.enabled`` the MLPs are LUT-MU tables.
    The draws differ from ``jax.random``'s: tests carry JAX params across
    with ``convert.params_from_jax`` instead."""
    _check_uniform_dense(cfg)
    d = cfg.d_model
    params = {
        "embed": L.embed_init(gen, cfg.vocab_size, d, dtype),
        "final_norm": torch.zeros((d,), dtype=dtype, device=gen.device),
        "lm_head": L.dense_init(gen, d, cfg.vocab_size, dtype),
    }
    layers = None
    for l in range(cfg.num_layers):  # one layer at a time: no 2x peak
        layers = _stack_into(layers, _init_block(cfg, gen, dtype, serving), l,
                             cfg.num_layers)
    params["layers"] = layers
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


def _mlp_out(lp: dict, mlp_in: Tensor, cfg: ModelConfig, cd) -> Tensor:
    """The per-block MLP shared by every serving path (dense or LUT-MU)."""
    if "amm_mlp" in lp:
        return AMM.amm_mlp_apply(lp["amm_mlp"], mlp_in, cfg)
    m = lp["mlp"]
    return L.gated_mlp(mlp_in, m["w_gate"].to(cd), m["w_up"].to(cd),
                       m["w_down"].to(cd), cfg.act)


def _block_apply(cfg: ModelConfig, lp: dict, h: Tensor, positions: Tensor,
                 window, layer_idx: int, mlp_tap=None) -> Tensor:
    """One block over a full sequence (no cache): attention, then the MLP
    (dense or LUT-MU); ``mlp_tap(layer_idx, mlp_in)`` sees each MLP input.
    Mamba and MoE blocks are not ported (ROADMAP A10)."""
    if "mamba" in lp or "moe" in lp:
        raise NotImplementedError(
            "Mamba and MoE blocks are not ported yet (ROADMAP A10)")
    h = h + A.attention(lp["attn"], L.rms_norm(h, lp["ln1"], cfg.norm_eps),
                        cfg, positions=positions, window=window)
    mlp_in = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    if mlp_tap is not None:
        mlp_tap(layer_idx, mlp_in)
    return h + _mlp_out(lp, mlp_in, cfg, h.dtype)


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


def _head(params: dict, h: Tensor, cfg: ModelConfig, cd) -> Tensor:
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return (h @ params["lm_head"].to(cd)).to(torch.float32)


@torch.inference_mode()
def paged_decode_step(params: dict, token: Tensor, pos: Tensor,
                      page_table: Tensor, cache: Dict[str, Tensor],
                      cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
                      write_ok: Optional[Tensor] = None) -> Tensor:
    """One decode step against the paged KV cache.

    token: (B, 1) int; pos: (B,) per-row write positions; page_table:
    (B, max_pages) int32 (rows without a request point at the trash page);
    cache: ``{"k","v"}`` of (L, P, page_size, n_kv, hd), updated in place.
    Returns logits (B, 1, V) float32.
    """
    _check_uniform_dense(cfg)
    cd = compute_dtype
    h = params["embed"].to(cd)[token.to(torch.int64)]  # (B, 1, D)
    for l, win in enumerate(window_flags(cfg)):
        lp = layer_params(params["layers"], l)
        h = h + A.paged_decode_step(
            lp["attn"], L.rms_norm(h, lp["ln1"], cfg.norm_eps), cfg,
            cache["k"][l], cache["v"][l], page_table, pos, win,
            write_ok=write_ok)
        h = h + _mlp_out(lp, L.rms_norm(h, lp["ln2"], cfg.norm_eps), cfg, cd)
    return _head(params, h, cfg, cd)


@torch.inference_mode()
def paged_prefill_chunk(params: dict, tokens: Tensor, start, n_valid,
                        page_row: Tensor, cache: Dict[str, Tensor],
                        cfg: ModelConfig, *,
                        compute_dtype=torch.bfloat16) -> Tensor:
    """One chunk of a single request's prefill against the paged cache.

    tokens: (1, cs) right-padded to the engine's chunk width; start /
    n_valid: tokens already prefilled / real tokens in this chunk, ints or
    0-d integer tensors on the tokens' device (as in JAX, one program then
    serves every chunk: nothing here reads them on the host); page_row:
    (max_pages,) int32.  The cache is updated in place.  Returns logits
    (1, 1, V) float32 at the chunk's last valid position (position 0 when
    ``n_valid`` is 0, a chunk that writes only the trash page).
    """
    _check_uniform_dense(cfg)
    cd = compute_dtype
    start = torch.as_tensor(start, device=tokens.device)
    n_valid = torch.as_tensor(n_valid, device=tokens.device)
    last = torch.clamp(n_valid.to(torch.int64) - 1, min=0).reshape(1)
    h = params["embed"].to(cd)[tokens.to(torch.int64)]
    for l, win in enumerate(window_flags(cfg)):
        lp = layer_params(params["layers"], l)
        h = h + A.paged_prefill_chunk(
            lp["attn"], L.rms_norm(h, lp["ln1"], cfg.norm_eps), cfg, start,
            n_valid, cache["k"][l], cache["v"][l], page_row, win)
        h = h + _mlp_out(lp, L.rms_norm(h, lp["ln2"], cfg.norm_eps), cfg, cd)
    return _head(params, h.index_select(1, last), cfg, cd)


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
    _check_uniform_dense(cfg)
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

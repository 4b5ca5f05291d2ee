"""GQA attention (PyTorch), as in ``repro.models.attention``: full-sequence
attention (training, scoring, the quality probe's eager replay), prefill
and decode against the fixed-slot cache, the paged KV cache, and Whisper's
cross-attention.

Weights are stored flat, ``(D, H·hd)``, as in the JAX package.  The slot
cache is one layer's ``(B, S_max, n_kv, hd)``; the paged cache one layer's
``(P, page_size, n_kv, hd)`` page pool (the last page is the engine's trash
page).  The new tokens' K/V are written into either **in place** — the JAX
functions return an updated copy instead.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import fused_verify as FV
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor

NEG_INF = FV.NEG_INF


def init_attn_params(cfg: ModelConfig, gen: torch.Generator,
                     dtype=torch.float32) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dev = gen.device
    p = {
        "wq": L.dense_init(gen, d, nq * hd, dtype),
        "wk": L.dense_init(gen, d, nkv * hd, dtype),
        "wv": L.dense_init(gen, d, nkv * hd, dtype),
        "wo": L.dense_init(gen, nq * hd, d, dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", nq * hd), ("bk", nkv * hd), ("bv", nkv * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(params: dict, x: Tensor, cfg: ModelConfig,
                 positions: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(b, s, nq, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _grouped(q: Tensor, nkv: int) -> Tensor:
    """(B, S, Hq, hd) → (B, S, n_kv, group, hd)."""
    b, s, nq, hd = q.shape
    return q.reshape(b, s, nkv, nq // nkv, hd)


def _direct_attention(q: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tensor:
    """Materialised-logits attention in the operands' type, softmax in
    float32.  q: (B, S, n_kv, g, hd); k/v: (B, T, n_kv, hd); mask: (S, T)
    additive."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bsngh,btnh->bngst", q, k).to(torch.float32) * scale
    logits = logits + mask[None, None, None]
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bngst,btnh->bsngh", w, v)


def _chunked_attention(q: Tensor, k: Tensor, v: Tensor, window,
                       causal: bool, chunk: int = 1024) -> Tensor:
    """Flash-style blockwise attention (running log-sum-exp) over KV
    chunks, in float32: memory O(S·chunk) instead of O(S²).  q: (B, S,
    n_kv, g, hd); k/v: (B, T, n_kv, hd); ``window`` None or an int.
    Returns (B, S, n_kv, g, hd) in q's type."""
    b, s, nkv, g, hd = q.shape
    t = k.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    q_pos = torch.arange(s, device=dev)
    qf = q.to(torch.float32)
    m = torch.full((b, nkv, g, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, nkv, g, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, nkv, g, s, hd), dtype=torch.float32, device=dev)
    for start in range(0, t, chunk):
        kb = k[:, start:start + chunk].to(torch.float32)
        vb = v[:, start:start + chunk].to(torch.float32)
        kv_pos = start + torch.arange(kb.shape[1], device=dev)
        logits = torch.einsum("bsngh,btnh->bngst", qf, kb) * scale
        valid = torch.ones((s, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            valid = valid & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            valid = valid & (kv_pos[None, :] > q_pos[:, None] - window)
        logits = torch.where(valid[None, None, None], logits,
                             torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bngst,btnh->bngsh", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def attention(params: dict, x: Tensor, cfg: ModelConfig, *,
              positions: Tensor, causal: bool = True,
              window: Optional[int] = None,
              chunked_threshold: int = 4096) -> Tensor:
    """Self-attention over a full sequence (no cache): (B, S, D) →
    (B, S, D).  Sequences of ``chunked_threshold`` tokens or more take the
    blockwise path."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    q, k, v = _project_qkv(params, x, cfg, positions)
    qg = _grouped(q, nkv)
    if s >= chunked_threshold:
        out = _chunked_attention(qg, k, v, window, causal)
    else:
        pos = torch.arange(s, device=x.device)
        ok = torch.ones((s, s), dtype=torch.bool, device=x.device)
        if causal:
            ok = pos[None, :] <= pos[:, None]
        if window is not None:
            ok = ok & (pos[None, :] > pos[:, None] - window)
        mask = torch.where(ok, 0.0, NEG_INF).to(torch.float32)
        out = _direct_attention(qg, k, v, mask)
    out = out.reshape(b, s, nq * hd)
    return out.to(x.dtype) @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# the slot cache: prefill and decode (the fixed-slot engine's path)
# ---------------------------------------------------------------------------


def _causal_mask(s: int, window: Optional[int], device) -> Tensor:
    pos = torch.arange(s, device=device)
    ok = pos[None, :] <= pos[:, None]
    if window is not None:
        ok = ok & (pos[None, :] > pos[:, None] - window)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def prefill_with_cache(params: dict, x: Tensor, cfg: ModelConfig,
                       positions: Tensor, window: Optional[int],
                       cache_len: int) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Full-sequence causal attention that also returns the populated KV
    cache: ``(out (B, S, D), (k, v))`` with k/v ``(B, cache_len, n_kv,
    hd)``, zero past S."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions)
    qg = _grouped(q, cfg.num_kv_heads)
    if s >= 4096:
        out = _chunked_attention(qg, k, v, window, True)
    else:
        out = _direct_attention(qg, k, v, _causal_mask(s, window, x.device))
    out = out.reshape(b, s, -1).to(x.dtype) @ params["wo"].to(x.dtype)
    pad = (0, 0, 0, 0, 0, cache_len - s)
    return out, (torch.nn.functional.pad(k, pad),
                 torch.nn.functional.pad(v, pad))


def decode_step(params: dict, x: Tensor, cfg: ModelConfig, cache_k: Tensor,
                cache_v: Tensor, pos: Tensor, window: Optional[int],
                split=None, par=None) -> Tensor:
    """One-token decode against a slot cache.

    x: (B, 1, D); cache_k/v: (B, S_max, n_kv, hd), written in place (int8
    caches quantise on write); pos: (B,) per-row position of the new token
    (row ``b``'s ``[0:pos[b]]`` is its history), or one position for every
    row.  The read is the paged path's :func:`FV.decode_attend`.  Returns
    (B, 1, D).

    ``split`` (``ParallelContext.seq_split``: the group's axes, this
    rank's shard index) says the caches hold one shard of the sequence:
    a row writes its K/V only on the rank that holds its position, and
    the read is the partial softmax of :func:`_split_read` over the group.
    """
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    pos_b = pos.to(torch.int64).reshape(-1).expand(b)
    q, k, v = _project_qkv(params, x, cfg, pos_b[:, None])
    if cache_k.dtype == torch.int8:
        k, v = _quantize_kv_int8(k, v)
    rows = torch.arange(b, device=x.device)
    qg = _grouped(q, nkv)
    if split is None:
        cache_k[rows, pos_b] = k[:, 0].to(cache_k.dtype)  # in place
        cache_v[rows, pos_b] = v[:, 0].to(cache_v.dtype)
        out = FV.decode_attend(qg, cache_k, cache_v, pos_b, window)
    else:
        axes, shard = split
        start = shard * cache_k.shape[1]
        at = pos_b - start
        mine = ((at >= 0) & (at < cache_k.shape[1]))[:, None, None]
        at = torch.clamp(at, 0, cache_k.shape[1] - 1)
        # rows are distinct: a blend at the clamped slot races with nothing
        for cache, new in ((cache_k, k), (cache_v, v)):
            cache[rows, at] = torch.where(mine, new[:, 0].to(cache.dtype),
                                          cache[rows, at])
        out = _split_read(qg, cache_k, cache_v, pos_b, window, start, axes,
                          par)
    out = out.reshape(b, 1, nq * hd).to(x.dtype).contiguous()
    return out @ params["wo"].to(x.dtype)


def _split_read(qg: Tensor, cache_k: Tensor, cache_v: Tensor,
                pos_b: Optional[Tensor], window: Optional[int], start: int,
                axes, par, rounded: bool = True) -> Tensor:
    """:func:`FV.decode_attend` (or, with ``pos_b`` ``None`` and not
    ``rounded``, cross-attention's read) over a sequence cut over the mesh
    group ``axes``, this rank's shard starting at global position
    ``start``: the plain pieces of ``FV.decode_attend_split`` with its
    three sums as all-reduces (the row maximum, the denominators, the
    value products)."""
    lg = FV.split_logits(qg, cache_k, pos_b, window, start)
    m = par.seq_max(lg.amax(dim=-1, keepdim=True), axes)
    s = par.seq_sum(FV.split_exp_sum(lg, m), axes)
    out = par.seq_sum(FV.split_values(lg, m, s, cache_v, rounded), axes)
    return FV.split_finish(out, cache_v.dtype if rounded else torch.float32)


def _quantize_kv_int8(k: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
    """Quantise new K/V on write to an int8 cache: integer-valued float32
    in [-127, 127] (the caller casts to the page type)."""
    k = torch.clamp(torch.round(k.to(torch.float32) / FV.KV_INT8_SCALE), -127, 127)
    v = torch.clamp(torch.round(v.to(torch.float32) / FV.KV_INT8_SCALE), -127, 127)
    return k, v


def _pool_trash(k_pages: Tensor, par) -> int:
    """The trash page's global id: the pool's last page.  On a pool cut
    over ``data`` a rank's shard ends with its write-sink page, which is
    no page of the pool."""
    if par is None or not par.pool_cut:
        return k_pages.shape[0] - 1
    return par.dp * (k_pages.shape[0] - 1) - 1


def _page_write(k_pages: Tensor, v_pages: Tensor, phys: Tensor, off: Tensor,
                k: Tensor, v: Tensor, par) -> None:
    """Write K/V at global pages ``phys``, offsets ``off``, in place.  On
    a pool cut over ``data`` a rank writes the pages it holds; every other
    write lands on its write-sink page (its shard's last, never read), so
    the write keeps static shapes and no two rows meet on a page of the
    pool that is read."""
    if par is not None and par.pool_cut:
        held = k_pages.shape[0] - 1
        mine, local = par.pool_place(phys, held)
        phys = torch.where(mine, local, torch.full_like(local, held))
    k_pages[phys, off] = k.to(k_pages.dtype)  # in place
    v_pages[phys, off] = v.to(v_pages.dtype)


def _pool_view(k_pages: Tensor, v_pages: Tensor, table: Tensor, par,
               rows_split: bool) -> Tuple[Tensor, Tensor]:
    """The logical K/V views of the rows this rank computes (``table``
    holds every row; with ``rows_split`` the rank's rows are its data
    rank's).  On a pool cut over ``data`` each rank gathers what it holds
    of every row's view, zeros elsewhere, and the parts are summed over
    ``data`` bitwise (``ParallelContext.pool_sum``): a reduce-scatter by
    rows when they split, else an all-reduce."""
    if par is None or not par.pool_cut:
        if rows_split:
            table = par.local_rows(table)
        return FV.paged_view(k_pages, v_pages, table)
    held = k_pages.shape[0] - 1
    k_part, v_part = FV.paged_view_part(k_pages, v_pages, table,
                                        par.dp_rank * held, held)
    kv = par.pool_sum(torch.stack([k_part, v_part], dim=1), rows_split)
    return kv[:, 0], kv[:, 1]


def decode_read(device, par) -> str:
    """The read :func:`paged_decode_step` runs after its page write:
    ``kernel`` for tensors on a CUDA device whose pool is not cut over
    ``data``; ``plain`` otherwise (the CPU, and a pool cut over ``data``,
    whose view is a sum over ranks that no kernel reads in place)."""
    on_card = torch.device(device).type == "cuda"
    return "kernel" if on_card and (par is None or not par.pool_cut) else "plain"


def paged_decode_step(params: dict, x: Tensor, cfg: ModelConfig,
                      k_pages: Tensor, v_pages: Tensor, page_table: Tensor,
                      pos: Tensor, window: Optional[int],
                      write_ok: Optional[Tensor] = None, par=None) -> Tensor:
    """One-token decode against one layer's paged KV cache.

    x: (B, 1, D); k_pages/v_pages: (P, page_size, n_kv, hd), written in
    place; page_table: (B, max_pages) int32, trash-padded; pos: (B,) write
    index per row.  ``write_ok`` ((B,) bool) sends a row's K/V write to the
    trash page.  Returns the attention output (B, 1, D).

    On a mesh (``par``) ``x`` holds this data rank's rows of the batch and
    the other inputs the whole batch.  With more than one data rank the
    pages are the rank's shard of the pool (``PagedKVCache(pad_to=)``,
    plus a write-sink page): the step's K/V are gathered over ``data`` and
    each rank writes the rows whose pages it holds (:func:`_page_write`),
    then reads its rows' views from every rank's pages
    (:func:`_pool_view`).

    The read after the write (:func:`decode_read`): on a CUDA device the
    hand-written kernel reads each row's pages in place, only the
    positions its mask reaches (``FV.decode_attend_paged_cuda``, the
    verify kernel at W = 1); on the CPU, and under a pool cut over
    ``data``, the plain read, ``FV.decode_attend`` over the gathered
    view.
    """
    b_all = page_table.shape[0]
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    pos_all = pos.to(torch.int64).reshape(-1).expand(b_all)
    split = par is not None and par.rows_split(b_all)
    pos_b = par.local_rows(pos_all) if split else pos_all
    b = pos_b.shape[0]
    q, k, v = _project_qkv(params, x, cfg, pos_b[:, None])
    if k_pages.dtype == torch.int8:
        k, v = _quantize_kv_int8(k, v)
    if split:
        k, v = par.gather_rows(k, b_all), par.gather_rows(v, b_all)
    ps = k_pages.shape[1]
    trash = _pool_trash(k_pages, par)
    rows = torch.arange(b_all, device=x.device)
    # a position past the table (a masked step of the speculative loops)
    # clamps onto the last entry, as the JAX gather does; write_ok then
    # sends its write to the trash page
    page_idx = torch.clamp(pos_all // ps, max=page_table.shape[1] - 1)
    phys = page_table.to(torch.int64)[rows, page_idx]
    if write_ok is not None:
        phys = torch.where(write_ok, phys, torch.full_like(phys, trash))
    _page_write(k_pages, v_pages, phys, pos_all % ps, k[:, 0], v[:, 0], par)
    qg = _grouped(q, nkv)
    if decode_read(x.device, par) == "kernel":  # one data rank: no row split
        out = FV.decode_attend_paged_cuda(
            qg.to(torch.float32).contiguous(), k_pages, v_pages,
            page_table.to(torch.int32).contiguous(),
            pos_b.to(torch.int32).contiguous(), window)
    else:
        if x.device.type == "cuda":
            FV.PLAIN_DECODE_ON_CUDA.bump()
        k_view, v_view = _pool_view(k_pages, v_pages, page_table, par, split)
        out = FV.decode_attend(qg, k_view, v_view, pos_b, window)
    # contiguous before the product: a strided operand can take another
    # GEMM path, and the verify window must see the same bits
    out = out.reshape(b, 1, nq * hd).to(x.dtype).contiguous()
    return out @ params["wo"].to(x.dtype)


def paged_prefill_chunk(params: dict, x: Tensor, cfg: ModelConfig,
                        start, n_valid, k_pages: Tensor,
                        v_pages: Tensor, page_row: Tensor,
                        window: Optional[int], par=None) -> Tensor:
    """Chunked-prefill attention for ONE request against the paged cache.

    x: (1, cs, D), right-padded to the engine's chunk width; ``start``:
    tokens already prefilled; ``n_valid`` ≤ cs real tokens in this chunk
    (each an int or a 0-d integer tensor, never read on the host);
    page_row: (max_pages,) int32, trash-padded.  Writes the chunk's K/V in
    place (padding rows go to the trash page), then attends the chunk's
    queries against the gathered view under the causal(+window) mask.  On
    a pool cut over ``data`` (``par``) every data rank computes the chunk,
    writes the positions whose pages it holds and reads the row's view
    all-reduced over ``data`` (:func:`_page_write`, :func:`_pool_view`).
    """
    b, cs, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dev = x.device
    idx = start + torch.arange(cs, device=dev)  # logical positions
    q, k, v = _project_qkv(params, x, cfg, idx[None])
    if k_pages.dtype == torch.int8:
        k, v = _quantize_kv_int8(k, v)
    ps = k_pages.shape[1]
    trash = _pool_trash(k_pages, par)
    row = page_row.to(torch.int64)
    valid_tok = torch.arange(cs, device=dev) < n_valid
    phys = torch.where(valid_tok, row[torch.clamp(idx // ps, max=row.shape[0] - 1)],
                       torch.full_like(idx, trash))
    _page_write(k_pages, v_pages, phys, idx % ps, k[0], v[0], par)
    k_view, v_view = _pool_view(k_pages, v_pages, page_row[None], par, False)
    if k_pages.dtype == torch.int8:
        # int8 pages: prefill reads the dequantised view in float
        k_view = k_view.to(torch.float32) * FV.KV_INT8_SCALE
        v_view = v_view.to(torch.float32) * FV.KV_INT8_SCALE
    kv_pos = torch.arange(k_view.shape[1], device=dev)
    ok = kv_pos[None, :] <= idx[:, None]
    if window is not None:
        ok = ok & (kv_pos[None, :] > idx[:, None] - window)
    mask = torch.where(ok, 0.0, NEG_INF).to(torch.float32)  # (cs, S) additive
    out = _direct_attention(_grouped(q, nkv), k_view.to(x.dtype),
                            v_view.to(x.dtype), mask)
    out = out.reshape(b, cs, nq * hd).to(x.dtype)
    return out @ params["wo"].to(x.dtype)


def paged_verify_window(params: dict, x: Tensor, cfg: ModelConfig,
                        k_pages: Tensor, v_pages: Tensor, page_table: Tensor,
                        pos: Tensor, n_valid: Tensor, window: Optional[int],
                        attend_impl: str = "auto") -> Tensor:
    """One layer's attention over the whole speculative-verify window.

    x: (B, W, D), the ln1-normalised hidden states of the ``W = k+1``
    window tokens; pos: (B,) first window position per row; n_valid: (B,)
    real tokens in each row's window (the rest write to the trash page, as
    ``paged_decode_step``'s ``write_ok`` does).  Writes the window's K/V in
    place and returns (B, W, D).

    The same values as W successive ``paged_decode_step`` attention blocks:
    Q/K/V and ``wo`` are applied per token at the oracle's ``(B, 1, ·)``
    shapes, all W keys/values go in with one batched page write, and every
    window position attends under its own ``kv_pos <= pos + j`` mask, so
    the later window slots are invisible to it.  ``attend_impl``: ``auto``
    → the CUDA kernel on CUDA tensors, the plain version on CPU tensors
    (``kernels/fused_verify.py``).
    """
    b, w, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dev = x.device
    pos_b = pos.to(torch.int64).reshape(-1).expand(b)
    qs, ks, vs = [], [], []
    for j in range(w):
        q, k, v = _project_qkv(params, x[:, j:j + 1].contiguous(), cfg,
                               (pos_b + j)[:, None])
        if k_pages.dtype == torch.int8:
            k, v = _quantize_kv_int8(k, v)
        qs.append(q)
        ks.append(k)
        vs.append(v)
    q = torch.cat(qs, dim=1)                          # (B, W, nq, hd)
    ps = k_pages.shape[1]
    trash = k_pages.shape[0] - 1
    offs = torch.arange(w, device=dev)
    wpos = pos_b[:, None] + offs[None, :]             # (B, W) logical pos
    page_idx = torch.clamp(wpos // ps, max=page_table.shape[1] - 1)
    phys = torch.where(offs[None, :] < n_valid.to(dev)[:, None],
                       torch.gather(page_table.to(torch.int64), 1, page_idx),
                       torch.full_like(wpos, trash))
    off = wpos % ps
    # in place; duplicate trash targets are never read unmasked
    k_pages[phys, off] = torch.cat(ks, dim=1).to(k_pages.dtype)
    v_pages[phys, off] = torch.cat(vs, dim=1).to(v_pages.dtype)
    qg = _grouped(q, nkv)                             # (B, W, n_kv, g, hd)
    if FV.resolve_impl(attend_impl, dev) == "cuda":
        out = FV.verify_window_attend_cuda(
            qg.to(torch.float32).contiguous(), k_pages, v_pages,
            page_table.to(torch.int32).contiguous(),
            pos_b.to(torch.int32).contiguous(), window)
    else:
        out = FV.verify_window_attend_plain(qg, k_pages, v_pages, page_table,
                                            pos_b, window)
    wo = params["wo"].to(x.dtype)
    return torch.cat([out[:, j].reshape(b, 1, nq * hd).to(x.dtype)
                      .contiguous() @ wo for j in range(w)], dim=1)


# ---------------------------------------------------------------------------
# cross attention (Whisper decoder → encoder states)
# ---------------------------------------------------------------------------


def init_cross_attn_params(cfg: ModelConfig, gen: torch.Generator,
                           dtype=torch.float32) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": L.dense_init(gen, d, nq * hd, dtype),
        "wk": L.dense_init(gen, d, nkv * hd, dtype),
        "wv": L.dense_init(gen, d, nkv * hd, dtype),
        "wo": L.dense_init(gen, nq * hd, d, dtype),
    }


def cross_attention(params: dict, x: Tensor, enc: Tensor,
                    cfg: ModelConfig) -> Tensor:
    """x: (B, S, D) decoder states; enc: (B, T, D) encoder states →
    (B, S, D), unmasked."""
    b, s, _ = x.shape
    t = enc.shape[1]
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, nq, hd)
    k = (enc @ params["wk"].to(x.dtype)).reshape(b, t, nkv, hd)
    v = (enc @ params["wv"].to(x.dtype)).reshape(b, t, nkv, hd)
    mask = torch.zeros((s, t), dtype=torch.float32, device=x.device)
    out = _direct_attention(_grouped(q, nkv), k, v, mask)
    return out.reshape(b, s, nq * hd).to(x.dtype) @ params["wo"].to(x.dtype)


def cross_decode(params: dict, x: Tensor, cross_k: Tensor, cross_v: Tensor,
                 cfg: ModelConfig, split=None, par=None) -> Tensor:
    """One decoder token's cross-attention against the cached encoder K/V
    ``(B, T, n_kv, hd)``, in float32: x (B, 1, D) → (B, 1, D).  ``split``
    as :func:`decode_step` takes it: the K/V hold one shard of the encoder
    positions, read by the partial softmax."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    q = (x @ params["wq"].to(x.dtype)).reshape(b, 1, nq, hd)
    if split is not None:
        axes, shard = split
        out = _split_read(_grouped(q, nkv), cross_k, cross_v, None, None,
                          shard * cross_k.shape[1], axes, par, rounded=False)
        return out.reshape(b, 1, nq * hd).to(x.dtype) @ params["wo"].to(
            x.dtype)
    lg = torch.einsum("bsngh,btnh->bngst", _grouped(q, nkv).float(),
                      cross_k.float()) * (1.0 / math.sqrt(hd))
    w = torch.softmax(lg, dim=-1)
    out = torch.einsum("bngst,btnh->bsngh", w, cross_v.float())
    return out.reshape(b, 1, nq * hd).to(x.dtype) @ params["wo"].to(x.dtype)

"""The masked attention read of the paged decode path, and the fused
speculative-verify window, as in ``repro/kernels/fused_verify.py``.

``decode_attend`` is the plain masked read, over a gathered cache view.
The verify window scores all ``W = k+1`` draft positions of a row against
one view of its pages: position ``j``'s mask (``kv_pos <= pos + j``)
already hides the later window slots, so the W attends are independent.

Which read runs where:

* the paged decode step (``models/attention.py::paged_decode_step``, and
  with it the scan oracle of ``models/model.py::paged_verify_step`` and
  the draft loop): on a CUDA device :func:`decode_attend_paged_cuda`, the
  kernel below at W = 1, reading the pages in place; on the CPU, and under
  a pool cut over ``data``, ``decode_attend`` over :func:`paged_view`;
* the verify window, by :func:`resolve_impl` (the counterparts of the JAX
  package's ``xla`` and ``pallas`` lowerings):

  * ``plain`` — :func:`verify_window_attend_plain`: gather the page view
    once (:func:`paged_view`), then :func:`verify_window_attend`, a loop
    over window positions of the very :func:`decode_attend` call the
    plain decode read makes, so it is bitwise that read for every cache
    dtype;
  * ``cuda`` — :func:`verify_window_attend_cuda`.

The kernel (``csrc/verify_window.cu``) reads each row's pages through the
page table and computes all W attends without materialising the view,
the reachable positions split over a cluster of blocks
(:func:`verify_splits`, :func:`split_slice`) that share one flat softmax
per row.  Its int8 path sums in int32 (exact, any order).  A float row
one block holds whole is summed on the CUDA cores in the plain version's
order as its library calls take it: each logit one FMA chain over the
head dim; each output one FMA chain over the positions, or, in a block of
at most 8 query rows (the decode read), four partials over 256-position
chunks as the library's value product sums the decode shapes, so the
decode read at B = 32, S = 1,024 and 1,536 is bitwise the plain read on
the card.  Split rows, and bf16 rows on the tensor cores, sum in another
order, so the float paths are held ``allclose``.

``auto`` picks ``cuda`` for CUDA tensors and ``plain`` for CPU tensors;
the plain version runs on a CUDA tensor only when asked for by name.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

NEG_INF = -1e30
KV_INT8_SCALE = 0.05
GLOBAL_WINDOW = 2**30  # the "no window" sentinel of the window flags

VERIFY_IMPLS = ("plain", "cuda")

LAUNCHES = _build.LaunchCount()
# calls of the plain version on CUDA tensors (only ever by name); the chip
# smoke run asserts the main path made none
PLAIN_ON_CUDA = _build.LaunchCount()
# the paged decode read: kernel launches (W = 1), and plain reads of CUDA
# tensors (``models/attention.py::paged_decode_step`` under a pool cut)
DECODE_LAUNCHES = _build.LaunchCount()
PLAIN_DECODE_ON_CUDA = _build.LaunchCount()

_MAX_ROWS = 64           # W·g query rows of one (row, kv head)
_ROWS_PER_BLOCK = 32     # csrc/verify_window.cu kRowsBlk
_MAX_HD = 256
_TILE_S = 32             # csrc/verify_window.cu kTileS
_MAX_SPLITS = 8          # blocks per cluster (the portable cluster size)
_SPLIT_SPAN = 512        # positions per split
_SMEM_LOGITS_MAX = 96 * 1024   # logits of a block above this go to scratch
_KV_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def reach(pos: int, w: int, window: int, s_len: int) -> Tuple[int, int]:
    """Cache positions ``[lo, hi)`` any of a row's W window masks can reach
    (``kv_pos <= pos+j`` and ``kv_pos > pos+j-window``); all of ``[0, S)``
    when one row's mask is empty, whose softmax is then uniform over the
    whole row.  The kernel derives the same range from ``pos`` on the
    device."""
    rows = [(max(0, pos + j - window + 1), min(s_len - 1, pos + j))
            for j in range(w)]
    if any(lo > hi for lo, hi in rows):
        return 0, s_len
    return rows[0][0], rows[-1][1] + 1


def split_cap(s_len: int, splits: int) -> int:
    """Most positions one of ``splits`` blocks holds: a whole number of
    ``_TILE_S`` tiles covering ``ceil(s_len / splits)``."""
    return -(-(-(-s_len // splits)) // _TILE_S) * _TILE_S


def verify_splits(s_len: int, one_wave: Optional[Callable[[int, int], bool]] = None
                  ) -> Tuple[int, int]:
    """``(splits, cap)`` for rows of ``s_len`` positions: a cluster of
    ``splits`` ≤ 8 blocks per (row, kv head, 32 query rows), one per
    ``_SPLIT_SPAN`` positions, each holding at most ``cap`` positions
    (:func:`split_cap`).  ``one_wave(splits, cap)`` says whether every
    cluster of the grid runs at once; the count steps down (to half) to
    the first that does, else stays.  Fixed from S and the grid shape, so
    the host never reads ``pos``."""
    want = max(1, min(_MAX_SPLITS, -(-s_len // _SPLIT_SPAN)))
    if one_wave is not None:
        for splits in range(want, max(1, want // 2) - 1, -1):
            if one_wave(splits, split_cap(s_len, splits)):
                return splits, split_cap(s_len, splits)
    return want, split_cap(s_len, want)


def split_slice(lo: int, hi: int, splits: int, i: int) -> Tuple[int, int]:
    """Block ``i``'s positions ``[a, e)`` of the reach ``[lo, hi)``: slices
    of ``ceil((hi-lo)/splits)`` rounded up to whole tiles, in order; the
    last ones may be short or empty."""
    chunk = -(-(-(-(hi - lo) // splits)) // _TILE_S) * _TILE_S
    a = min(hi, lo + i * chunk)
    return a, min(hi, a + chunk)


def split_bf16_terms(q: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """float32 ``q`` as three bfloat16 terms ``hi + mid + lo`` that sum to
    it exactly (each remainder fits the next term's 8 significant bits), as
    the kernel feeds q to the bf16 tensor cores."""
    hi = q.to(torch.bfloat16)
    r1 = q - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


@functools.lru_cache(maxsize=None)
def _max_clusters(kv_code: int, w: int, g: int, hd: int, ps: int,
                  splits: int, cap: int, in_smem: bool) -> int:
    lib = _build.library("verify_window")
    return lib.verify_window_max_clusters(kv_code, w, g, hd, ps, splits, cap,
                                          int(in_smem))


def resolve_impl(impl: str = "auto", device=None) -> str:
    """``auto`` → ``cuda`` on a CUDA device, else ``plain``."""
    if impl == "auto":
        dev = torch.device(device) if device is not None else None
        return "cuda" if dev is not None and dev.type == "cuda" else "plain"
    if impl not in VERIFY_IMPLS:
        raise ValueError(
            f"verify attend impl must be 'auto' or one of {VERIFY_IMPLS}, "
            f"got {impl!r}")
    return impl


def decode_attend(qg: Tensor, cache_k: Tensor, cache_v: Tensor, pos_b: Tensor,
                  window: Optional[int]) -> Tensor:
    """Masked one-token attention read over a ``(B, S, n_kv, hd)`` cache
    view.  qg: (B, 1, n_kv, g, hd); returns (B, 1, n_kv, g, hd) float32.
    The plain read: the paged decode step's on the CPU and under a pool
    cut (on a card it reads through :func:`decode_attend_paged_cuda`), the
    slot cache's, and the oracle of the kernel's tests.

    Float caches: the products accumulate in float32 over the upcast cache,
    as the JAX ``preferred_element_type=f32`` einsums do; the softmax
    weights are rounded to the cache's type before the value product.

    int8 caches: q and the softmax weights are quantised on the fly and the
    products sum exactly (integers far below 2**24, summed in float64), then
    rescale.  q is quantised from float32 whatever the compute type — the
    JAX function quantises in the compute type, which is the same at
    float32 and lets the CUDA kernel, which takes float32 q, agree with
    this version at bf16 too.
    """
    hd = qg.shape[-1]
    kv_pos = torch.arange(cache_k.shape[1], device=qg.device)
    valid = kv_pos[None, :] <= pos_b[:, None]  # (B, S)
    if window is not None:
        valid = valid & (kv_pos[None, :] > pos_b[:, None] - window)
    valid = valid[:, None, None, None, :]
    scale = 1.0 / math.sqrt(hd)
    if cache_k.dtype == torch.int8:
        q = qg.float()
        sq = torch.amax(q.abs(), dim=-1, keepdim=True) / 127.0 + 1e-9
        q_i8 = torch.clamp(torch.round(q / sq), -127, 127)
        logits = torch.einsum("bsngh,btnh->bngst", q_i8.double(),
                              cache_k.double()).float()
        logits = logits * (sq.permute(0, 2, 3, 1, 4) * KV_INT8_SCALE * scale)
        logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
        w = torch.softmax(logits, dim=-1)
        w_i8 = torch.clamp(torch.round(w * 127.0), 0, 127)
        out = torch.einsum("bngst,btnh->bsngh", w_i8.double(),
                           cache_v.double()).float()
        return out * (KV_INT8_SCALE / 127.0)
    logits = torch.einsum("bsngh,btnh->bngst", qg.float(),
                          cache_k.float()) * scale
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bngst,btnh->bsngh", w.to(cache_v.dtype).float(),
                        cache_v.float())


def paged_view(k_pages: Tensor, v_pages: Tensor, page_table: Tensor
               ) -> Tuple[Tensor, Tensor]:
    """Gather the logical ``(B, S, n_kv, hd)`` view of the physical
    ``(P, page_size, n_kv, hd)`` pages through a ``(B, max_pages)``
    page table."""
    b = page_table.shape[0]
    nkv, hd = k_pages.shape[2], k_pages.shape[3]
    idx = page_table.to(torch.int64)
    return (k_pages[idx].reshape(b, -1, nkv, hd),
            v_pages[idx].reshape(b, -1, nkv, hd))


def paged_view_part(k_pages: Tensor, v_pages: Tensor, page_table: Tensor,
                    lo: int, held: int) -> Tuple[Tensor, Tensor]:
    """One page shard's part of :func:`paged_view`: the shard holds the
    global pages ``[lo, lo + held)`` as its first ``held`` physical pages;
    entries of the table it does not hold read as zeros.  The parts of
    every shard summed bitwise (:func:`sum_parts`) are the whole view."""
    local = page_table.to(torch.int64) - lo
    mine = (local >= 0) & (local < held)
    k_view, v_view = paged_view(k_pages, v_pages,
                                torch.where(mine, local, 0))
    b, mp = page_table.shape
    keep = mine.repeat_interleave(k_pages.shape[1], dim=1).reshape(
        b, -1, 1, 1)
    return (torch.where(keep, k_view, torch.zeros_like(k_view)),
            torch.where(keep, v_view, torch.zeros_like(v_view)))


def sum_parts(parts) -> Tensor:
    """Parts of which at most one is non-zero at each element, summed in
    order on int32 views of their bytes: bitwise the non-zero one (the
    last dim's bytes a multiple of 4)."""
    acc = parts[0].contiguous().view(torch.int32).clone()
    for p in parts[1:]:
        acc += p.contiguous().view(torch.int32)
    return acc.view(parts[0].dtype)


# the slot cache's read split over sequence shards (a cache whose sequence
# is cut over a mesh group): each shard's masked logits, a global row
# maximum, a global sum of exp(logit - max), then the weights formed and
# rounded as decode_attend rounds them and the partial value products
# summed.  decode_attend_split chains the pieces over shards in rank order;
# on a mesh the three sums are collectives (models/attention.py).


def split_logits(qg: Tensor, cache_k: Tensor, pos_b: Optional[Tensor],
                 window: Optional[int], start: int) -> Tensor:
    """One sequence shard's logits ``(B, n_kv, g, 1, S_shard)`` float32 as
    :func:`decode_attend` forms them, the shard holding the global
    positions ``[start, start + S_shard)``; positions outside each row's
    ``pos_b``/``window`` mask are ``NEG_INF``.  ``pos_b`` ``None``: no
    mask, float products (cross-attention's read)."""
    hd = qg.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    if pos_b is not None and cache_k.dtype == torch.int8:
        q = qg.float()
        sq = torch.amax(q.abs(), dim=-1, keepdim=True) / 127.0 + 1e-9
        q_i8 = torch.clamp(torch.round(q / sq), -127, 127)
        logits = torch.einsum("bsngh,btnh->bngst", q_i8.double(),
                              cache_k.double()).float()
        logits = logits * (sq.permute(0, 2, 3, 1, 4) * KV_INT8_SCALE * scale)
    else:
        logits = torch.einsum("bsngh,btnh->bngst", qg.float(),
                              cache_k.float()) * scale
    if pos_b is None:
        return logits
    kv_pos = start + torch.arange(cache_k.shape[1], device=qg.device)
    valid = kv_pos[None, :] <= pos_b[:, None]
    if window is not None:
        valid = valid & (kv_pos[None, :] > pos_b[:, None] - window)
    return torch.where(valid[:, None, None, None, :], logits,
                       torch.full_like(logits, NEG_INF))


def split_exp_sum(logits: Tensor, m: Tensor) -> Tensor:
    """A shard's ``sum(exp(logit - m))`` per row, ``m`` the global row
    maximum ``(…, 1)``."""
    return torch.exp(logits - m).sum(dim=-1, keepdim=True)


def split_values(logits: Tensor, m: Tensor, s: Tensor, cache_v: Tensor,
                 rounded: bool = True) -> Tensor:
    """A shard's value product with the global softmax weights
    ``exp(logit - m) / s``, rounded as :func:`decode_attend` rounds them:
    to the cache's type (float caches; not at all without ``rounded``, as
    cross-attention reads), or to ``round(w·127)`` (int8 caches, whose
    products are exact integers, summed in float64).  Returns
    ``(B, 1, n_kv, g, hd)``: float32, float64 for int8."""
    w = torch.exp(logits - m) / s
    if rounded and cache_v.dtype == torch.int8:
        w_i8 = torch.clamp(torch.round(w * 127.0), 0, 127)
        return torch.einsum("bngst,btnh->bsngh", w_i8.double(),
                            cache_v.double())
    if rounded:
        w = w.to(cache_v.dtype).float()
    return torch.einsum("bngst,btnh->bsngh", w, cache_v.float())


def split_finish(out: Tensor, kv_dtype) -> Tensor:
    """The summed value products as :func:`decode_attend` returns them."""
    if kv_dtype == torch.int8:
        return out.float() * (KV_INT8_SCALE / 127.0)
    return out


def decode_attend_split(qg: Tensor, k_shards, v_shards, pos_b: Tensor,
                        window: Optional[int]) -> Tensor:
    """:func:`decode_attend` over a cache view cut into sequence shards
    (in order), combined shard by shard in rank order: the split read a
    mesh runs with its sums as collectives.  Its only differences from
    the whole read are the two float sums (the softmax's denominator and
    the value products) taken in parts: within a few float32 ulps before
    the weights are rounded, so a weight may land one rounding step of
    the cache type (one ``round(w·127)`` step for int8) away."""
    starts = [0]
    for k in k_shards[:-1]:
        starts.append(starts[-1] + k.shape[1])
    lgs = [split_logits(qg, k, pos_b, window, st)
           for k, st in zip(k_shards, starts)]
    m = lgs[0].amax(dim=-1, keepdim=True)
    for lg in lgs[1:]:
        m = torch.maximum(m, lg.amax(dim=-1, keepdim=True))
    s = sum(split_exp_sum(lg, m) for lg in lgs)
    out = sum(split_values(lg, m, s, v) for lg, v in zip(lgs, v_shards))
    return split_finish(out, k_shards[0].dtype)


def split_read_bound(w: Tensor, cache_v: Tensor, rel: float) -> Tensor:
    """The stated tolerance of :func:`decode_attend_split` against
    :func:`decode_attend`, per output element ``(B, 1, n_kv, g, hd)``:
    ``w`` are the whole read's softmax weights ``(B, n_kv, g, 1, S)``.
    Each weight of the split read lies within ``rel`` of itself; where
    that interval crosses a rounding boundary of the cache type (of
    ``round(w·127)`` for int8) the rounded weight moves by the step
    between the interval's ends, times its value; float value products
    add ``rel · Σ w·|v|`` for their other grouping.  int8 products are
    exact, so an int8 read differs only where a weight moved."""
    d = rel * w
    if cache_v.dtype == torch.int8:
        step = (torch.round(torch.clamp((w + d) * 127.0, 0, 127))
                - torch.round(torch.clamp((w - d) * 127.0, 0, 127)))
        return torch.einsum("bngst,btnh->bsngh", step.double(),
                            cache_v.double().abs()).float() * (
                                KV_INT8_SCALE / 127.0)
    dt = cache_v.dtype
    step = (w + d).to(dt).float() - (w - d).to(dt).float() + d
    return torch.einsum("bngst,btnh->bsngh", step, cache_v.float().abs())


def verify_window_attend(qg: Tensor, k_view: Tensor, v_view: Tensor,
                         pos: Tensor, window: Optional[int]) -> Tensor:
    """All W window positions attend against one ``(B, S, n_kv, hd)`` view.

    qg: (B, W, n_kv, g, hd); ``pos``: (B,) first window position per row.
    Position ``j`` reads with the mask ``kv_pos <= pos + j``: a loop of the
    exact :func:`decode_attend` call the scan oracle makes, so the result
    is bitwise the oracle's for every dtype.
    """
    outs = [decode_attend(qg[:, j:j + 1], k_view, v_view, pos + j, window)
            for j in range(qg.shape[1])]
    return torch.cat(outs, dim=1)


def verify_window_attend_plain(qg: Tensor, k_pages: Tensor, v_pages: Tensor,
                               page_table: Tensor, pos: Tensor,
                               window: Optional[int]) -> Tensor:
    """The kernel's plain version: gather the view once, then
    :func:`verify_window_attend`.  ``window`` ``None`` or the ``2**30``
    sentinel means global."""
    if qg.device.type == "cuda":
        PLAIN_ON_CUDA.bump()
    k_view, v_view = paged_view(k_pages, v_pages, page_table)
    return verify_window_attend(qg, k_view, v_view, pos.to(torch.int64),
                                window)


def _rows_blocks(w: int, g: int) -> Tuple[int, int]:
    """(query rows of a block, blocks of 32 rows per (row, kv head))."""
    return min(w * g, _ROWS_PER_BLOCK), -(-(w * g) // _ROWS_PER_BLOCK)


def _logits_in_smem(w: int, g: int, cap: int) -> bool:
    # a block keeps its slice's logits (≤ 32 rows × cap) in shared memory
    # when they fit the budget, else in a scratch allocated by the wrapper
    return _rows_blocks(w, g)[0] * (cap + 4) * 4 <= _SMEM_LOGITS_MAX


def max_clusters(kv_dtype, w: int, g: int, hd: int, ps: int, splits: int,
                 cap: int) -> int:
    """Clusters of ``splits`` blocks the card runs at once (the kernel's
    occupancy query), logits where :func:`_logits_in_smem` puts them."""
    return _max_clusters(_build.DTYPE_CODES[kv_dtype], w, g, hd, ps, splits,
                         cap, _logits_in_smem(w, g, cap))


def heuristic_splits(b: int, w: int, nkv: int, g: int, hd: int, ps: int,
                     s_len: int, kv_dtype,
                     query: Optional[Callable[..., int]] = max_clusters) -> int:
    """:func:`verify_splits`' count for this grid: the most splits whose
    clusters all run at once with the logits in shared memory, by
    ``query`` (the card's occupancy; ``None``: no card, the count from S
    alone)."""
    halves = _rows_blocks(w, g)[1]

    def one_wave(splits, cap):
        return _logits_in_smem(w, g, cap) and b * nkv * halves <= query(
            kv_dtype, w, g, hd, ps, splits, cap)

    return verify_splits(s_len, one_wave if query is not None else None)[0]


def check_splits(w: int, g: int, hd: int, ps: int, s_len: int, kv_dtype,
                 splits: int) -> None:
    """Raise unless ``splits`` is a count the kernel takes and the card
    runs at least one cluster of it."""
    _build.require(1 <= splits <= _MAX_SPLITS,
                   f"verify splits must be in [1, {_MAX_SPLITS}], got {splits}")
    n = max_clusters(kv_dtype, w, g, hd, ps, splits, split_cap(s_len, splits))
    _build.require(n >= 1, f"verify_window with {splits} splits fails the "
                   f"occupancy check at S={s_len}")


def verify_window_attend_cuda(qg: Tensor, k_pages: Tensor, v_pages: Tensor,
                              page_table: Tensor, pos: Tensor,
                              window: Optional[int],
                              splits: Optional[int] = None) -> Tensor:
    """Page gather + all W masked attends in one kernel.

    Args:
      qg: (B, W, n_kv, g, hd) float32; hd a multiple of 16, at most 256.
      k_pages / v_pages: (P, page_size, n_kv, hd) float32, bfloat16 or int8.
        qg and the pages 16-byte aligned (the kernel's 16-byte loads).
      page_table: (B, max_pages) int32, trash-padded.
      pos: (B,) int32 first window position per row.
      window: the layer's window (``None`` or ``2**30`` = global).
      splits: blocks per cluster; by default the autotune cache's entry
        for this shape, else :func:`heuristic_splits` (``kernels/
        autotune.py::get_verify_tiles``).  A count that fails
        :func:`check_splits` raises.

    Returns:
      (B, W, n_kv, g, hd) float32.  CPU tensors take the plain version.
    """
    if _build.on_cpu(qg, k_pages, v_pages, page_table, pos):
        return verify_window_attend_plain(qg, k_pages, v_pages, page_table,
                                          pos, window)
    out = _launch(qg, k_pages, v_pages, page_table, pos, window, splits)
    if out.numel():
        LAUNCHES.bump()
    return out


def decode_attend_paged_cuda(qg: Tensor, k_pages: Tensor, v_pages: Tensor,
                             page_table: Tensor, pos: Tensor,
                             window: Optional[int],
                             splits: Optional[int] = None) -> Tensor:
    """The paged decode step's masked read straight from the pages: the
    verify kernel at W = 1, each row reading only the positions its mask
    reaches.  Arguments as :func:`verify_window_attend_cuda`'s with
    ``qg`` (B, 1, n_kv, g, hd) and ``pos`` the rows' positions; counted
    in ``DECODE_LAUNCHES``.  Returns (B, 1, n_kv, g, hd) float32, what
    :func:`decode_attend` returns over the :func:`paged_view`; CPU
    tensors take that plain read."""
    _build.require(qg.dim() == 5 and qg.shape[1] == 1,
                   f"qg must be (B, 1, n_kv, g, hd), got {tuple(qg.shape)}")
    if _build.on_cpu(qg, k_pages, v_pages, page_table, pos):
        return decode_attend(qg, *paged_view(k_pages, v_pages, page_table),
                             pos.to(torch.int64), window)
    out = _launch(qg, k_pages, v_pages, page_table, pos, window, splits)
    if out.numel():
        DECODE_LAUNCHES.bump()
    return out


def _launch(qg: Tensor, k_pages: Tensor, v_pages: Tensor, page_table: Tensor,
            pos: Tensor, window: Optional[int],
            splits: Optional[int]) -> Tensor:
    """Check the CUDA tensors and launch ``csrc/verify_window.cu``."""
    win = GLOBAL_WINDOW if window is None else int(window)
    _build.require(qg.dim() == 5, f"qg must be (B, W, n_kv, g, hd), got "
                   f"{tuple(qg.shape)}")
    b, w, nkv, g, hd = qg.shape
    _build.require(qg.dtype == torch.float32, f"qg must be float32, got {qg.dtype}")
    _build.require(k_pages.dtype in _KV_DTYPES and v_pages.dtype == k_pages.dtype,
                   f"pages must share one dtype of {_KV_DTYPES}, got "
                   f"{k_pages.dtype}/{v_pages.dtype}")
    _build.require(k_pages.dim() == 4 and k_pages.shape == v_pages.shape
                   and tuple(k_pages.shape[2:]) == (nkv, hd),
                   f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)} must "
                   f"be (P, page_size, {nkv}, {hd})")
    _build.require(page_table.dtype == torch.int32 and page_table.dim() == 2
                   and page_table.shape[0] == b,
                   f"page_table must be int32 ({b}, max_pages), got "
                   f"{page_table.dtype} {tuple(page_table.shape)}")
    _build.require(pos.dtype == torch.int32 and tuple(pos.shape) == (b,),
                   f"pos must be int32 ({b},), got {pos.dtype} {tuple(pos.shape)}")
    _build.require(1 <= w * g <= _MAX_ROWS,
                   f"W·g = {w * g} query rows per block, must be in [1, {_MAX_ROWS}]")
    _build.require(1 <= hd <= _MAX_HD and hd % 16 == 0,
                   f"head_dim {hd} must be a multiple of 16 in [16, {_MAX_HD}]")
    _build.require(win >= 1, f"window must be >= 1, got {win}")
    _build.require_contiguous(qg=qg, k_pages=k_pages, v_pages=v_pages,
                              page_table=page_table, pos=pos)
    _build.require(all(t.data_ptr() % 16 == 0 for t in (qg, k_pages, v_pages)),
                   "qg and the pages must be 16-byte aligned (16-byte loads)")
    ps, max_pages = k_pages.shape[1], page_table.shape[1]
    s_len = ps * max_pages
    out = torch.empty((b, w, nkv, g, hd), dtype=torch.float32, device=qg.device)
    if out.numel() == 0:
        return out
    if splits is None:
        from repro_torch.kernels import autotune as AT  # no import cycle
        splits = AT.get_verify_tiles(s_len, w, nkv, g, hd, k_pages.dtype, b=b,
                                     page_size=ps, device=qg.device).splits
    check_splits(w, g, hd, ps, s_len, k_pages.dtype, splits)
    cap = split_cap(s_len, splits)
    in_smem = _logits_in_smem(w, g, cap)
    halves = _rows_blocks(w, g)[1]
    scratch = (None if in_smem else
               torch.empty((b, nkv * halves, splits, _ROWS_PER_BLOCK, cap + 4),
                           dtype=torch.float32, device=qg.device))
    lib = _build.library("verify_window")
    err = lib.verify_window_launch(
        qg.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        _build.DTYPE_CODES[k_pages.dtype], page_table.data_ptr(),
        pos.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        b, w, nkv, g, hd, ps, max_pages, win, splits, cap, int(in_smem),
        _build.stream_of(qg))
    _build.check(lib, err, "verify_window")
    return out

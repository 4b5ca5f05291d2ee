"""MADDNESS (Blalock & Guttag, ICML'21) in PyTorch: the offline fit and
the online path, as in ``repro.core.maddness``.

  * offline fit — per codebook, a depth-``I`` bisecting hash tree (split
    dims + per-node thresholds), the ``G = 2**I`` prototypes (bucket means
    or the full-width ridge solution) and the LUT of partial dot products
    against a known weight; it runs in torch on the device of its input,
    batched over codebooks;
  * online path — gather the split values, encode each codebook's
    sub-vector to a prototype id (sequential tree walk or parallel
    comparators), and aggregate the selected LUT rows.

The tree fit reproduces the JAX package's numpy arithmetic step for step
(stable sorts, sequential cumulative sums, numpy's pairwise order for the
sum over the ``d_sub`` dims, first minimum), so on the same float64 input
it picks the same split dims and thresholds on the CPU and on the card;
only two losses within rounding of each other can pick apart
(:func:`learn_hash_trees` ``margins=True`` reports how close each pick
was).

Shapes follow the paper: an input of width ``D`` splits into ``C``
codebooks of ``d_sub = D // C`` dims; a depth-``I`` tree per codebook picks
one of ``G = 2**I`` prototypes.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class HashTree:
    """Per-codebook bisecting decision trees.

    Attributes:
      split_dims: (C, I) int32 — the dim (within the codebook's ``d_sub``
        subspace) compared at each level; all nodes of a level share it.
      thresholds: (C, 2**I - 1) float32 — per-node split values in heap
        order (node 0 = root, level ``l`` occupies ``[2**l - 1, 2**(l+1)-1)``).
    """

    split_dims: Tensor
    thresholds: Tensor

    @property
    def num_codebooks(self) -> int:
        return self.split_dims.shape[0]

    @property
    def depth(self) -> int:
        return self.split_dims.shape[1]

    @property
    def num_prototypes(self) -> int:
        return 2 ** self.depth


@dataclasses.dataclass
class MaddnessParams:
    """Everything needed for one LUT-based approximate matmul ``x @ W``.

    Attributes:
      tree: the hash trees (encode parameters).
      prototypes: (C, G, d_sub) float32, or None — only needed offline.
      lut: (C, G, N) float32/bfloat16, or int8 when quantised.
      lut_scale: () or (N,) float32 dequant scale.
      lut_offset: () or (N,) float32 dequant offset.
    """

    tree: HashTree
    prototypes: Optional[Tensor]
    lut: Tensor
    lut_scale: Tensor
    lut_offset: Tensor

    @property
    def out_features(self) -> int:
        return self.lut.shape[-1]


def gather_split_values(x: Tensor, tree: HashTree) -> Tensor:
    """(B, D) → (B, C, I): the only input values the encode ever reads."""
    b = x.shape[0]
    c_books, depth = tree.split_dims.shape
    xs = x.reshape(b, c_books, x.shape[1] // c_books)
    idx = tree.split_dims.to(torch.int64)[None].expand(b, c_books, depth)
    return torch.gather(xs, 2, idx)


def encode(x_split: Tensor, tree: HashTree) -> Tensor:
    """Sequential tree-walk encode (Eq. 3): (B, C, I) → (B, C) int32 ids."""
    b, c_books, depth = x_split.shape
    thr = tree.thresholds[None].expand(b, -1, -1)
    node = torch.zeros((b, c_books), dtype=torch.int64, device=x_split.device)
    for level in range(depth):
        t = torch.gather(thr, 2, node[..., None])[..., 0]
        node = 2 * node + 1 + (x_split[:, :, level] >= t).to(torch.int64)
    return (node - (2**depth - 1)).to(torch.int32)


def _leaf_paths(depth: int):
    """Static (G, I) node indices + expected bits along each root→leaf path."""
    g = 2**depth
    nodes = np.zeros((g, depth), dtype=np.int64)
    bits = np.zeros((g, depth), dtype=bool)
    for leaf in range(g):
        node = 0
        for level in range(depth):
            nodes[leaf, level] = node
            bit = (leaf >> (depth - 1 - level)) & 1
            bits[leaf, level] = bool(bit)
            node = 2 * node + 1 + bit
    return nodes, bits


def encode_onehot(x_split: Tensor, tree: HashTree,
                  dtype=torch.float32) -> Tensor:
    """Parallel-comparator encode → (B, C, G) one-hot over prototypes.

    All ``2**I - 1`` node comparisons at once, then an AND along each of
    the ``2**I`` root→leaf paths (the paper's Encoder, Section V-B3).
    """
    b, c_books, depth = x_split.shape
    g = 2**depth
    dev = x_split.device
    levels = torch.as_tensor(
        np.floor(np.log2(np.arange(1, g))).astype(np.int64), device=dev)
    cmp = x_split[:, :, levels] >= tree.thresholds[None]  # (B, C, G-1)
    nodes, bits = _leaf_paths(depth)
    path = cmp[:, :, torch.as_tensor(nodes.reshape(-1), device=dev)]
    path = path.reshape(b, c_books, g, depth)
    want = torch.as_tensor(bits, device=dev)[None, None]
    return (path == want).all(dim=-1).to(dtype)


def _epilogue(acc: Tensor, lut_scale: Tensor, lut_offset: Tensor) -> Tensor:
    # two roundings, as the kernels' __fmul_rn/__fadd_rn epilogue
    return acc.to(torch.float32) * lut_scale + lut_offset


def aggregate(codes: Tensor, lut: Tensor, lut_scale: Tensor,
              lut_offset: Tensor) -> Tensor:
    """Reference LUT aggregation (Eq. 4): gather + sum.  codes (B, C) →
    (B, N) float32; int8 LUTs sum in int32."""
    c_books = lut.shape[0]
    ar = torch.arange(c_books, device=lut.device)
    gathered = lut[ar[None, :], codes.to(torch.int64)]  # (B, C, N)
    acc = gathered.to(torch.int32 if lut.dtype == torch.int8 else torch.float32)
    return _epilogue(acc.sum(dim=1, dtype=acc.dtype), lut_scale, lut_offset)


def onehot_gather_sum(lhs: Tensor, rhs: Tensor) -> Tensor:
    """``lhs (B, K) @ rhs (K, N)`` summed over ``lhs``'s nonzero entries only.

    Exact for integer operands (int32 accumulation, no float matmul that
    TF32 could round) and the natural form for one-hot left operands: each
    nonzero ``lhs[b, k]`` adds ``lhs[b, k] · rhs[k, :]`` to row ``b``.  An
    int8 ``rhs`` accumulates in int32, anything else in float32.
    """
    int_path = rhs.dtype == torch.int8
    acc_dtype = torch.int32 if int_path else torch.float32
    rows, cols = torch.nonzero(lhs, as_tuple=True)
    vals = lhs[rows, cols].to(acc_dtype)
    out = torch.zeros((lhs.shape[0], rhs.shape[1]), dtype=acc_dtype,
                      device=rhs.device)
    return out.index_add_(0, rows, vals[:, None] * rhs[cols].to(acc_dtype))


def aggregate_onehot(onehot: Tensor, lut: Tensor, lut_scale: Tensor,
                     lut_offset: Tensor) -> Tensor:
    """One-hot aggregation ``Σ_{c,g} onehot[b,c,g] · lut[c,g,n]`` — the
    (B, C·G) × (C·G, N) contraction, with the LUT in the one-hot's type."""
    lhs = onehot.reshape(onehot.shape[0], -1)
    rhs = lut.reshape(-1, lut.shape[-1]).to(lhs.dtype)
    return _epilogue(onehot_gather_sum(lhs, rhs), lut_scale, lut_offset)


def contract_onehot(onehot: Tensor, lut: Tensor, lut_scale: Tensor,
                    lut_offset: Tensor) -> Tensor:
    """dtype-dispatching one-hot contraction: int8 LUTs accumulate in int32
    (integer one-hot), float LUTs go through :func:`aggregate_onehot`."""
    if lut.dtype == torch.int8:
        lhs = onehot.to(torch.int8).reshape(onehot.shape[0], -1)
        acc = onehot_gather_sum(lhs, lut.reshape(-1, lut.shape[-1]))
        return _epilogue(acc, lut_scale, lut_offset)
    return aggregate_onehot(onehot, lut, lut_scale, lut_offset)


def maddness_matmul(x: Tensor, params: MaddnessParams) -> Tensor:
    """Full online path: gather → encode → aggregate.  x: (B, D) → (B, N)."""
    codes = encode(gather_split_values(x, params.tree), params.tree)
    return aggregate(codes, params.lut, params.lut_scale, params.lut_offset)


def maddness_matmul_onehot(x: Tensor, params: MaddnessParams) -> Tensor:
    """One-hot online path — numerically identical to the reference."""
    onehot = encode_onehot(gather_split_values(x, params.tree), params.tree)
    return contract_onehot(onehot, params.lut, params.lut_scale,
                           params.lut_offset)


# ---------------------------------------------------------------------------
# Offline fit (torch, on the input's device, batched over codebooks).
# ---------------------------------------------------------------------------

# float64 entries of one padded (codebooks × buckets × rows × dims) block
# of the tree fit: codebooks are taken in chunks that keep it below this
_TREE_BLOCK = 1 << 24


@contextlib.contextmanager
def exact_fp32_matmul():
    """float32 matmuls in full float32 for the block (no TF32 on the card),
    as the JAX package's float32 einsums on the CPU."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def as_tensor(a, dtype: torch.dtype, device=None) -> Tensor:
    """An array or tensor as a ``dtype`` tensor on ``device`` (default: the
    tensor's own device, the CPU for an array)."""
    if isinstance(a, Tensor):
        return a.to(device=device if device is not None else a.device,
                    dtype=dtype)
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


def _sum_dims_numpy_order(t: Tensor) -> Tensor:
    """Sum over the last axis in numpy's order for a contiguous reduction
    of at most 128 entries: sequential below 8 entries; else eight
    accumulators over strides of 8, combined pairwise, then the tail."""
    n = t.shape[-1]
    if n < 8:
        acc = t[..., 0]
        for i in range(1, n):
            acc = acc + t[..., i]
        return acc
    if n > 128:
        raise ValueError(f"d_sub={n} > 128 is not supported")
    body = n - n % 8
    r = [t[..., j] for j in range(8)]
    for i in range(8, body, 8):
        r = [r[j] + t[..., i + j] for j in range(8)]
    acc = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for i in range(body, n):
        acc = acc + t[..., i]
    return acc


def _sum0_xla_order(t: Tensor, window: int = 32) -> Tensor:
    """Sum over axis 0 in the order of XLA's CPU tree reduction (the JAX
    package's ``sum(axis=0)``): while more than ``window`` rows remain, pad
    with zero rows split evenly front and back to a multiple of
    ``window`` and sum each window sequentially; then sum the rest
    sequentially.  Zero rows leave every partial sum unchanged."""
    def seq(rows: Tensor) -> Tensor:
        acc = rows[0]
        for i in range(1, rows.shape[0]):
            acc = acc + rows[i]
        return acc

    while t.shape[0] > window:
        pad = -t.shape[0] % window
        zeros = torch.zeros_like(t[:1])
        t = torch.cat([zeros.expand(pad // 2, *t.shape[1:]), t,
                       zeros.expand(pad - pad // 2, *t.shape[1:])])
        t = seq(t.reshape(-1, window, *t.shape[1:]).transpose(0, 1))
    return seq(t)


def _rel_gap(sorted_vals: Tensor) -> Tensor:
    """(second - first) / |first| of ascending values on the last axis
    (inf where there is no second)."""
    if sorted_vals.shape[-1] < 2:
        return torch.full(sorted_vals.shape[:-1], float("inf"),
                          dtype=torch.float64, device=sorted_vals.device)
    a, b = sorted_vals[..., 0], sorted_vals[..., 1]
    return torch.where(torch.isfinite(b), (b - a) / a.abs().clamp_min(1e-300),
                       torch.full_like(b, float("inf")))


def _dim_splits(xs: Tensor, bucket: Tensor, n_buckets: int, k: int):
    """One candidate split dim ``k`` for every bucket of every codebook.

    xs (C, N, d) float64, bucket (C, N) int64.  Returns the summed loss
    (C,) float64 in bucket order, thresholds (C, n_buckets) float32 and
    each bucket's relative gap between its two best cuts (C, n_buckets).
    Each bucket's rows are sorted by dim ``k`` (stable, ties in row order),
    then laid out padded with zeros after its last row so the cumulative
    sums restart per bucket; the sums run row by row, as numpy's do."""
    c, n, d = xs.shape
    dev = xs.device
    order = torch.argsort(xs[..., k], dim=1, stable=True)
    order = order.gather(1, torch.argsort(bucket.gather(1, order), dim=1,
                                          stable=True))
    bs = bucket.gather(1, order)
    m = torch.zeros((c, n_buckets), dtype=torch.int64, device=dev)
    m.scatter_add_(1, bucket, torch.ones_like(bucket))
    starts = torch.cumsum(m, dim=1) - m
    pos = torch.arange(n, device=dev)[None] - starts.gather(1, bs)
    rows = int(m.max())
    padded = torch.zeros((c, n_buckets, rows, d), dtype=torch.float64,
                         device=dev)
    cb = torch.arange(c, device=dev)[:, None].expand(c, n)
    padded[cb, bs, pos] = xs.gather(1, order[..., None].expand(c, n, d))
    sums = torch.stack((padded, padded * padded))  # cumsum, cumsum of squares
    for i in range(1, rows):
        sums[:, :, :, i].add_(sums[:, :, :, i - 1])
    last = (m - 1).clamp_min(0)[None, :, :, None, None].expand(
        2, c, n_buckets, 1, d)
    total = sums.gather(3, last)  # (2, C, nb, 1, d)
    left = sums[:, :, :, :-1]
    right = total - left
    cnt = torch.arange(1, rows, dtype=torch.float64, device=dev)[:, None]
    right_cnt = m[:, :, None, None].to(torch.float64) - cnt
    sse = _sum_dims_numpy_order(
        (left[1] - left[0] * left[0] / cnt)
        + (right[1] - right[0] * right[0] / right_cnt))  # (C, nb, rows-1)
    valid = torch.arange(rows - 1, device=dev) <= (m - 2)[..., None]
    sse = torch.where(valid, sse, torch.full_like(sse, float("inf")))
    if rows >= 2:
        best = torch.argmin(sse, dim=2, keepdim=True)
        loss_b = sse.gather(2, best)[..., 0]
        lo = padded[..., k].gather(2, best)[..., 0]
        hi = padded[..., k].gather(2, best + 1)[..., 0]
        split_thr = 0.5 * (lo + hi)
        gap = _rel_gap(torch.topk(sse, min(2, rows - 1), dim=2,
                                  largest=False).values)
    else:
        loss_b = split_thr = torch.zeros((c, n_buckets), dtype=torch.float64,
                                         device=dev)
        gap = torch.full_like(loss_b, float("inf"))
    many = m >= 2
    loss_b = torch.where(many, loss_b, torch.zeros_like(loss_b))
    thr = torch.where(many, split_thr,
                      torch.where(m == 1, padded[:, :, 0, k],
                                  torch.zeros_like(split_thr)))
    loss = torch.zeros((c,), dtype=torch.float64, device=dev)
    for b in range(n_buckets):  # the loss of each bucket, in bucket order
        loss = loss + loss_b[:, b]
    return loss, thr.to(torch.float32), gap


def _learn_trees_chunk(xs: Tensor, depth: int):
    """Split dims, thresholds and the picks' margins of a chunk of
    codebooks; xs (C, N, d_sub) float64."""
    c, n, d = xs.shape
    dev = xs.device
    split_dims = torch.zeros((c, depth), dtype=torch.int32, device=dev)
    thresholds = torch.zeros((c, 2**depth - 1), dtype=torch.float32,
                             device=dev)
    dim_gap = torch.zeros((c, depth), dtype=torch.float64, device=dev)
    cut_gap = torch.zeros((c, 2**depth - 1), dtype=torch.float64, device=dev)
    bucket = torch.zeros((c, n), dtype=torch.int64, device=dev)
    for level in range(depth):
        nb = 2**level
        best_loss = torch.full((c,), float("inf"), dtype=torch.float64,
                               device=dev)
        best_dim = torch.full((c,), -1, dtype=torch.int64, device=dev)
        best_thr = torch.zeros((c, nb), dtype=torch.float32, device=dev)
        best_gap = torch.zeros((c, nb), dtype=torch.float64, device=dev)
        losses = []
        for k in range(d):
            loss, thr, gap = _dim_splits(xs, bucket, nb, k)
            better = loss < best_loss  # the first strict minimum, as numpy
            best_loss = torch.where(better, loss, best_loss)
            best_dim = torch.where(better, torch.full_like(best_dim, k),
                                   best_dim)
            best_thr = torch.where(better[:, None], thr, best_thr)
            best_gap = torch.where(better[:, None], gap, best_gap)
            losses.append(loss)
        split_dims[:, level] = best_dim.to(torch.int32)
        lo = 2**level - 1
        thresholds[:, lo:lo + nb] = best_thr
        dim_gap[:, level] = _rel_gap(torch.sort(torch.stack(losses, 1),
                                                dim=1).values)
        cut_gap[:, lo:lo + nb] = best_gap
        xd = xs.gather(2, best_dim[:, None, None].expand(c, n, 1))[..., 0]
        go_right = xd >= best_thr.to(torch.float64).gather(1, bucket)
        bucket = bucket * 2 + go_right.to(torch.int64)
    return split_dims, thresholds, dim_gap, cut_gap


def learn_hash_trees(x, num_codebooks: int, depth: int, seed: int = 0, *,
                     margins: bool = False, device=None):
    """Learn the bank of hash trees from calibration data (MADDNESS §4.1).

    Each level's nodes share one split dim: every dim of the ``d_sub``
    subspace is scored by the exact two-sided SSE, over the whole subspace,
    of each bucket's best cut on it; the threshold sits midway between the
    two rows straddling the cut, an empty bucket gets 0.0 and a one-row
    bucket that row's value.

    Args:
      x: (N, D) calibration activations (array or tensor; fitted in float64
        on ``device``, by default the tensor's own); D must divide by
        ``num_codebooks``.
      seed: unused (the fit is deterministic), kept for the JAX signature.
      margins: also return, per codebook, the relative gap between the
        best and second-best level loss over dims, ``"dim"`` (C, I), and
        between each node's best and second-best cut on the chosen dim,
        ``"cut"`` (C, 2**I - 1): a pick whose gap is within rounding can
        differ between two machines' arithmetic.
    """
    del seed
    xt = as_tensor(x, torch.float64, device)
    n, d = xt.shape
    if d % num_codebooks:
        raise ValueError(f"D={d} not divisible by C={num_codebooks}")
    d_sub = d // num_codebooks
    xs = xt.reshape(n, num_codebooks, d_sub).permute(1, 0, 2).contiguous()
    # a level's padded block holds at most 2**(depth-1) buckets of N rows
    chunk = max(1, _TREE_BLOCK // (n * d_sub * 2**(depth - 1)))
    parts = [_learn_trees_chunk(xs[i:i + chunk], depth)
             for i in range(0, num_codebooks, chunk)]
    split_dims, thresholds, dim_gap, cut_gap = (torch.cat(p) for p in
                                                zip(*parts))
    tree = HashTree(split_dims=split_dims, thresholds=thresholds)
    if margins:
        return tree, {"dim": dim_gap, "cut": cut_gap}
    return tree


def _onehot(assign: Tensor, g: int, dtype: torch.dtype) -> Tensor:
    """(N, c) prototype ids → (N, c·g) one-hot."""
    n, c = assign.shape
    out = torch.zeros((n, c, g), dtype=dtype, device=assign.device)
    out.scatter_(2, assign[..., None], 1)
    return out.reshape(n, c * g)


def learn_prototypes(x, tree: HashTree, ridge_lambda: float = 1.0,
                     optimize: bool = True) -> Tensor:
    """Prototypes = bucket means, optionally globally ridge-optimised.

    MADDNESS §4.2: after hashing, solve ``min_P ||X - A P||² + λ||P||²``
    where ``A`` is the (N, C·G) one-hot assignment.  The optimised
    prototypes are full-width: each codebook's prototype compensates the
    quantisation error of the others.  The Gram matrix ``AᵀA`` holds exact
    integer counts (a float32 product of 0/1 entries, exact below 2**24
    rows); ``AᵀX`` sums in float64; the solve is a float64 Cholesky
    (``AᵀA + λI`` is symmetric positive definite for λ > 0).  Runs on the
    tree's device.

    Returns:
      float32 (C, G, d_sub) bucket means when ``optimize=False``, else
      (C, G, D) — the float64 solution rounded, as the JAX package returns
      it with 64-bit floats off.
    """
    dev = tree.thresholds.device
    x64 = as_tensor(x, torch.float64, dev)
    n, d = x64.shape
    c_books, depth = tree.split_dims.shape
    g = 2**depth
    d_sub = d // c_books
    assign = encode(gather_split_values(x64, tree), tree).to(torch.int64)
    k = c_books * g
    # codebooks per block: a (N, step·G) one-hot and a (step·G, C·G) slab
    # of the Gram matrix of at most 2**27 entries each
    step = max(1, min((1 << 27) // (n * g), (1 << 27) // (g * k)))
    if not optimize:
        protos = torch.zeros((c_books, g, d_sub), dtype=torch.float64,
                             device=dev)
        xs = x64.reshape(n, c_books, d_sub)
        for lo in range(0, c_books, step):
            hi = min(c_books, lo + step)
            oh = _onehot(assign[:, lo:hi], g, torch.float64).reshape(
                n, hi - lo, g).permute(1, 2, 0)  # (c, G, N)
            sums = torch.bmm(oh, xs[:, lo:hi].permute(1, 0, 2))
            counts = oh.sum(dim=2, keepdim=True)
            protos[lo:hi] = torch.where(counts > 0, sums / counts.clamp_min(1),
                                        torch.zeros_like(sums))
        return protos.to(torch.float32)

    a32 = _onehot(assign, g, torch.float32)  # (N, C·G), exact 0/1
    gram = torch.empty((k, k), dtype=torch.float64, device=dev)
    rhs = torch.empty((k, d), dtype=torch.float64, device=dev)
    with exact_fp32_matmul():
        for lo in range(0, c_books, step):
            hi = min(c_books, lo + step)
            rows = slice(lo * g, hi * g)
            gram[rows] = (a32[:, rows].T @ a32).to(torch.float64)
            rhs[rows] = a32[:, rows].T.to(torch.float64) @ x64
    del a32
    gram.diagonal().add_(ridge_lambda)
    chol = torch.linalg.cholesky(gram)
    del gram
    sol = torch.cholesky_solve(rhs, chol)  # (C·G, D) full-width prototypes
    del chol, rhs
    return sol.to(torch.float32).reshape(c_books, g, d)


def quantize_lut_bits(lut: Tensor, bits: int = 8,
                      bias: Optional[Tensor] = None
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """Quantise a float32 (C, G, N) LUT to ``bits``-wide integer codes.

    Per-(c, n) offsets (the min over prototypes) absorbed into one
    per-column offset, a per-column scale covering the widest codebook's
    range, codes stored as int8 (int4 codes in ``[-8, 7]``); every step in
    float32 and the offsets summed over codebooks in the JAX package's
    order, so the result is bit-equal to its on the same table.  Per-column separable, so it commutes with column
    pruning.

    Returns:
      (q, scale, offset): int8 codes and per-column (N,) float32 scale and
      offset with ``out ≈ (Σ_c q[c, g_c]) · scale + offset``.
    """
    if bits not in (4, 8):
        raise ValueError(f"LUT codes must be 4 or 8 bits, got {bits}")
    c_books = lut.shape[0]
    levels = 2**bits
    half = levels // 2
    mins = lut.amin(dim=1)  # (C, N)
    rng = (lut.amax(dim=1) - mins).amax(dim=0)  # (N,)
    scale = torch.clamp_min(rng, 1e-8) / (levels - 1.0)
    q = torch.round((lut - mins[:, None, :]) / scale) - float(half)
    q = torch.clamp(q, -half, half - 1).to(torch.int8)
    offset = _sum0_xla_order(mins) + float(half) * c_books * scale
    if bias is not None:
        offset = offset + bias
    return q, scale.to(torch.float32), offset.to(torch.float32)


def build_lut(prototypes: Tensor, weight: Tensor,
              bias: Optional[Tensor] = None, quantize_int8: bool = False
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """Precompute the LUT of partial dot products (Eq. 2), in float32
    without TF32.

    Args:
      prototypes: (C, G, d_sub) subspace prototypes, or (C, G, D)
        full-width ridge-optimised ones (MADDNESS §4.2).
      weight: (D, N) float32 with D = C · d_sub.
      bias: optional (N,), folded into the dequant offset.

    Returns:
      (lut, scale, offset): float32 (C, G, N) with scale 1 and offset the
      bias, or int8 codes with per-column scale and offset
      (:func:`quantize_lut_bits`).
    """
    c_books, g, pdim = prototypes.shape
    d, n = weight.shape
    with exact_fp32_matmul():
        if pdim == d:  # full-width prototypes
            lut = (prototypes.reshape(c_books * g, d) @ weight).reshape(
                c_books, g, n)
        elif pdim * c_books == d:
            lut = torch.bmm(prototypes, weight.reshape(c_books, pdim, n))
        else:
            raise ValueError(f"prototype dim {pdim} incompatible with D={d}, "
                             f"C={c_books}")
    if not quantize_int8:
        offset = (bias if bias is not None
                  else torch.zeros((n,), dtype=torch.float32,
                                   device=lut.device))
        return (lut.to(torch.float32),
                torch.ones((), dtype=torch.float32, device=lut.device), offset)
    return quantize_lut_bits(lut, bits=8, bias=bias)


def fit_maddness(calib_x, weight, num_codebooks: int, depth: int = 4,
                 bias=None, quantize_int8: bool = False,
                 optimize_prototypes: bool = True, ridge_lambda: float = 1.0,
                 seed: int = 0, device=None) -> MaddnessParams:
    """One-shot offline fit on ``device`` (default: ``calib_x``'s):
    trees → prototypes → LUT."""
    x = as_tensor(calib_x, torch.float64, device)
    tree = learn_hash_trees(x, num_codebooks, depth, seed=seed)
    protos = learn_prototypes(x, tree, ridge_lambda=ridge_lambda,
                              optimize=optimize_prototypes)
    lut, scale, offset = build_lut(
        protos, as_tensor(weight, torch.float32, x.device),
        None if bias is None else as_tensor(bias, torch.float32, x.device),
        quantize_int8=quantize_int8)
    return MaddnessParams(tree, protos, lut, scale, offset)


def compare_trees(got: HashTree, want: HashTree, margins: dict,
                  rel: float = 1e-12):
    """Codebook by codebook, the first level where two fits of the same
    data disagree (split dim or a threshold of the level's nodes).

    A disagreement is *excused* when ``margins`` (from
    ``learn_hash_trees(..., margins=True)`` of either fit) show a near-tie
    at that level: the best and second-best dim losses, or some node's two
    best cuts, within ``rel`` relative of each other — two machines'
    roundings may then pick apart, and every later level of the codebook
    follows from the pick.  Returns ``(excused, unexcused)``, lists of
    ``(codebook, level)``."""
    sd_a, sd_b = got.split_dims.cpu(), want.split_dims.cpu()
    th_a, th_b = got.thresholds.cpu(), want.thresholds.cpu()
    dim_gap, cut_gap = margins["dim"].cpu(), margins["cut"].cpu()
    excused, unexcused = [], []
    for c in range(sd_a.shape[0]):
        for level in range(sd_a.shape[1]):
            lo, hi = 2**level - 1, 2**(level + 1) - 1
            if (sd_a[c, level] == sd_b[c, level]
                    and torch.equal(th_a[c, lo:hi], th_b[c, lo:hi])):
                continue
            near = (dim_gap[c, level] <= rel
                    or bool((cut_gap[c, lo:hi] <= rel).any()))
            (excused if near else unexcused).append((c, level))
            break
    return excused, unexcused

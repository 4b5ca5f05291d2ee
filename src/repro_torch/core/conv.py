"""Im2col / Kn2col convolution lowering for LUT-MU (paper Section V-A4,
Fig. 5), as in ``repro.core.conv``.

Im2col flattens each K×K×D_in window into one vector, which scatters split
dims across channels and windows and defeats pruning.  Kn2col treats a
window as K² channel vectors: the convolution becomes K² (H·W, D_in) ×
(D_in, D_out) matmuls on shifted feature maps, summed in (ky, kx) order —
each a standard LUT-MU with codebooks along channels.

Activations are NHWC and weights HWIO, as in the JAX package, so a Kn2col
tap's rows are the JAX rows in the same order.  The lowerings pad
``(K-1)//2`` on every side (``"SAME"``) as the JAX lowerings do;
:func:`conv_reference` follows XLA's ``"SAME"``, which puts the odd pixel of
a strided convolution's padding at the end, so the two agree at stride 2
only where the padding is even (odd input sizes for K = 3).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _pad_same(x: Tensor, k: int) -> Tensor:
    pad = (k - 1) // 2
    return F.pad(x, (0, 0, pad, pad, pad, pad))  # NHWC: W then H


def im2col_patches(x: Tensor, k: int, stride: int = 1,
                   padding: str = "SAME") -> Tensor:
    """(B, H, W, D_in) → (B, H_out, W_out, K·K·D_in) unfolded windows,
    taps-major ((ky, kx, d)) order."""
    if padding == "SAME":
        x = _pad_same(x, k)
    h_out = (x.shape[1] - k) // stride + 1
    w_out = (x.shape[2] - k) // stride + 1
    cols = [x[:, ky:ky + h_out * stride:stride, kx:kx + w_out * stride:stride]
            for ky in range(k) for kx in range(k)]
    return torch.cat(cols, dim=-1)


def conv_im2col(x: Tensor, w: Tensor, stride: int = 1, padding: str = "SAME",
                matmul: Optional[Callable[[Tensor, Tensor], Tensor]] = None
                ) -> Tensor:
    """Convolution via Im2col.  ``w``: (K, K, D_in, D_out);
    ``matmul(flat_x, flat_w)`` swaps in a LUT-MU (default exact ``@``)."""
    k = w.shape[0]
    patches = im2col_patches(x, k, stride, padding)
    b, ho, wo, dk = patches.shape
    flat_w = w.reshape(-1, w.shape[-1])  # (K·K·D_in, D_out), same tap order
    mm = matmul if matmul is not None else (lambda a, bm: a @ bm)
    return mm(patches.reshape(-1, dk), flat_w).reshape(b, ho, wo, -1)


def conv_kn2col(x: Tensor, w: Tensor, stride: int = 1, padding: str = "SAME",
                tap_matmuls: Optional[Sequence[Callable[[Tensor], Tensor]]]
                = None) -> Tensor:
    """Convolution via Kn2col: K² shifted 1×1 matmuls, summed in (ky, kx)
    order.  ``tap_matmuls[t](rows)`` (t = ky·K + kx) substitutes one LUT-MU
    per tap (default exact ``rows @ w[ky, kx]``)."""
    b = x.shape[0]
    d_in = x.shape[-1]
    k = w.shape[0]
    xp = _pad_same(x, k) if padding == "SAME" else x
    h_out = (xp.shape[1] - k) // stride + 1
    w_out = (xp.shape[2] - k) // stride + 1
    out = None
    for ky in range(k):
        for kx in range(k):
            sl = xp[:, ky:ky + h_out * stride:stride,
                    kx:kx + w_out * stride:stride]
            rows = sl.reshape(-1, d_in)
            t = ky * k + kx
            part = (tap_matmuls[t](rows) if tap_matmuls is not None
                    else rows @ w[ky, kx])
            part = part.reshape(b, h_out, w_out, -1)
            out = part if out is None else out + part
    return out


def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_reference(x: Tensor, w: Tensor, stride: int = 1,
                   padding: str = "SAME") -> Tensor:
    """The exact convolution (NHWC, HWIO): ``F.conv2d`` behind a permute,
    with XLA's ``"SAME"`` padding (the odd pixel at the end)."""
    k = w.shape[0]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        top, bottom = _same_pads(x.shape[1], k, stride)
        left, right = _same_pads(x.shape[2], w.shape[1], stride)
        xc = F.pad(xc, (left, right, top, bottom))
    out = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return out.permute(0, 2, 3, 1)

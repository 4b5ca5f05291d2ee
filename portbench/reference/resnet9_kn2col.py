"""Plain PyTorch reference of ResNet-9 with Kn2col LUT-MU convolutions (the
paper's case study, §VI-B); it imports nothing of the program.

Activations NHWC, weights HWIO.  conv0 and the head are exact; conv1 …
res2b are Kn2col: a 3 × 3 ``SAME`` convolution as nine shifted 1 × 1
products, each a LUT-MU over the channel vectors (``maddness.py``),
summed in (ky, kx) order.  Each convolution is followed by ReLU; 2 × 2 max
pools after conv1, conv2 and conv3; residual blocks after the first pool
(res1a, res1b) and the last (res2a, res2b); a global mean and the head.

Float32 throughout.  The tree encode turns a one-ulp change of a compared
value into another table row, so every operation runs at the shapes and
layouts the program's forward gives it (the batch whole, the exact
convolution on a permuted NHWC view): a product of the same shapes sums
in the same order.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference import maddness as MR

Tensor = torch.Tensor

LAYERS = ("conv0", "conv1", "res1a", "res1b", "conv2", "conv3", "res2a",
          "res2b")


def tf32(t: Tensor) -> Tensor:
    """``t`` rounded to TF32's 10 mantissa bits (to nearest, ties away),
    as a tensor core reads float32 operands with TF32 on."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32).reshape(t.shape)


def conv_exact(x: Tensor, w: Tensor) -> Tensor:
    """Stride-1 3 × 3 ``SAME`` convolution (one pixel of zeros each side)."""
    xc = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1))
    return F.conv2d(xc, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def conv_kn2col(x: Tensor, taps: List[Dict],
                codes_seen: Optional[Callable] = None) -> Tensor:
    """Kn2col convolution: tap ``t = 3·ky + kx`` maps the channel vectors of
    the input shifted by ``(ky - 1, kx - 1)`` through its LUT-MU."""
    b, h, w, cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    for ky in range(3):
        for kx in range(3):
            tap = taps[3 * ky + kx]
            rows = xp[:, ky:ky + h, kx:kx + w].reshape(-1, cin)
            xs = MR.gather_split_values(rows, tap["split_dims"])
            part = MR.lutmu(xs, tap["thresholds"], tap["lut"], tap["scale"],
                            tap["offset"], codes_seen).reshape(b, h, w, -1)
            out = part if out is None else out + part
    return out


def pool(x: Tensor) -> Tensor:
    """2 × 2 max pool, stride 2 (NHWC)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class _Stop(Exception):
    def __init__(self, h: Tensor):
        self.h = h


def forward(params: Dict, x: Tensor, codes_seen: Optional[Callable] = None,
            stop_at: Optional[str] = None,
            operand: Callable[[Tensor], Tensor] = lambda t: t) -> Tensor:
    """Logits ``(B, classes)`` of images ``x (B, H, W, 3)``; ``params`` holds
    ``conv0``, ``head``, ``head_b`` and ``taps[layer]`` (nine LUT-MU dicts
    of ``split_dims``, ``thresholds``, ``lut``, ``scale``, ``offset``).
    With ``stop_at`` it returns that layer's input instead (only the taps
    of the layers before it are read).  ``operand`` maps each operand of
    the exact convolution and of the head (the control rounds them to
    TF32)."""
    def conv(name, h):
        if name == stop_at:
            raise _Stop(h)
        if name == "conv0":
            return conv_exact(operand(h), operand(params["conv0"]))
        return conv_kn2col(h, params["taps"][name], codes_seen)

    try:
        h = F.relu(conv("conv0", x))
        h = pool(F.relu(conv("conv1", h)))
        r = F.relu(conv("res1a", h))
        r = F.relu(conv("res1b", r))
        h = h + r
        h = pool(F.relu(conv("conv2", h)))
        h = pool(F.relu(conv("conv3", h)))
        r = F.relu(conv("res2a", h))
        r = F.relu(conv("res2b", r))
        h = h + r
    except _Stop as stop:
        return stop.h
    h = h.mean(dim=(1, 2))
    return operand(h) @ operand(params["head"]) + params["head_b"]

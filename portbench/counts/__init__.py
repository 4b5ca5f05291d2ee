"""Frozen operation and byte counts: the yardstick the per-layer metrics
divide by.  Nothing here reads the program; every count follows from a
configuration's shapes.

The peaks are NVIDIA's data-sheet figures for one H100 SXM (dense rates,
no sparsity, at the 700 W power limit).  ``bound_ms`` and the LUT-MU byte
count follow the kernel table's arithmetic: every input byte read once,
every output byte written once, and of the table only the rows the codes
select.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
PEAK_BF16_FLOPS = 989e12       # dense bf16 tensor-core rate
ADD_OPS_PER_S = 67e12          # float32 / int32 adds on the CUDA cores


def bound_ms(nbytes: float, ops: float, ops_per_s: float) -> Tuple[float, str]:
    """The least time a kernel could take: bytes over HBM bandwidth or
    operations over their peak rate, whichever is larger, in ms, and which
    of the two it was."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rows_needed(codes, g: int):
    """LUT rows a call reads: the distinct (codebook, leaf) pairs among its
    leaf ids ``codes (B, C)`` (``g`` leaves a codebook), as a 0-d tensor
    on the codes' device (no synchronisation)."""
    import torch
    c = codes.shape[1]
    flat = codes.to(torch.int64) + g * torch.arange(c, device=codes.device)[None]
    used = torch.zeros((c * g,), dtype=torch.int32, device=codes.device)
    return used.scatter_(0, flat.reshape(-1), 1).sum()


class TableRows:
    """The mean share of its table's rows a LUT-MU call reads, by call
    shape (rows, codebooks): a ``codes_seen`` hook of the references."""

    def __init__(self, g: int):
        self.g, self.sums = g, {}

    def __call__(self, codes) -> None:
        b, c = codes.shape
        tot, n = self.sums.get((b, c), (0, 0))
        self.sums[(b, c)] = (rows_needed(codes, self.g) + tot, n + 1)

    def share(self, b: int, c: int):
        """The share for calls of ``b`` rows over ``c`` codebooks, or
        ``None`` where none was seen."""
        if (b, c) not in self.sums:
            return None
        tot, n = self.sums[(b, c)]
        return float(tot) / n / (c * self.g)


def lutmu_bound_ms(b: int, c: int, n: int, depth: int, lut_itemsize: int,
                   lut_rows: float) -> Tuple[float, str]:
    """Bound of one fused LUT-MU call (encode + gather-sum + epilogue) of
    ``b`` rows, ``c`` codebooks of depth ``depth``, ``n`` output columns:
    split values and thresholds read once, ``lut_rows`` table rows of ``n``
    entries, the two epilogue vectors and the float32 output; ``b·c·n``
    gather-adds."""
    g = 2 ** depth
    nbytes = (b * c * depth * 4 + c * (g - 1) * 4 + lut_rows * n * lut_itemsize
              + 2 * n * 4 + b * n * 4)
    return bound_ms(nbytes, b * c * n, ADD_OPS_PER_S)


# ---------------------------------------------------------------------------
# dense-equivalent model FLOPs
# ---------------------------------------------------------------------------


def lm_token_flops(sizes: Dict, context: int, head: bool) -> float:
    """Forward FLOPs of one token of a dense decoder at ``sizes`` (the keys
    of a Hugging Face ``config.json``), counting every MLP as the dense
    gated MLP it approximates: 2 per multiply-add of the projections, the
    attention scores and values over ``context`` positions, and the
    vocabulary head when ``head``."""
    d = sizes["hidden_size"]
    nq, nkv = sizes["num_attention_heads"], sizes["num_key_value_heads"]
    hd = sizes["head_dim"]
    ff = sizes["intermediate_size"]
    proj = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
    per_layer = 2 * proj + 2 * 3 * d * ff + 2 * 2 * nq * hd * context
    flops = sizes["num_hidden_layers"] * per_layer
    if head:
        flops += 2 * d * sizes["vocab_size"]
    return float(flops)


def lm_span_flops(sizes: Dict, start: int, n: int, heads: int) -> float:
    """FLOPs of ``n`` consecutive tokens at positions ``start …
    start + n - 1`` (each attends to the positions up to its own), of which
    ``heads`` produce logits."""
    ctx_sum = n * start + n * (n + 1) // 2
    per_tok = lm_token_flops(sizes, 0, False)
    d, nq, hd = (sizes["hidden_size"], sizes["num_attention_heads"],
                 sizes["head_dim"])
    attn = sizes["num_hidden_layers"] * 2 * 2 * nq * hd * ctx_sum
    return n * per_tok + attn + heads * 2 * d * sizes["vocab_size"]


def conv_flops(h: int, w: int, cin: int, cout: int, k: int = 3) -> float:
    """FLOPs of a stride-1 ``SAME`` convolution producing ``h × w``."""
    return 2.0 * h * w * cin * cout * k * k


def resnet9_image_flops(sizes: Dict) -> float:
    """Dense-equivalent FLOPs of one ResNet-9 image (every LUT-MU layer
    counted as the exact convolution it approximates): 0.7585 GFLOP at
    widths 64/128/256/512 on 32 × 32 × 3."""
    return sum(conv_flops(h, w, cin, cout)
               for (h, w, cin, cout) in resnet9_convs(sizes).values()) + \
        2.0 * sizes["channels"][-1] * sizes["num_classes"]


def resnet9_convs(sizes: Dict) -> Dict[str, Tuple[int, int, int, int]]:
    """name → (output height, output width, cin, cout) of each convolution
    of ResNet-9 (pools after conv1, conv2 and conv3)."""
    c = sizes["channels"]
    h, w, cin = sizes["image"]
    return {"conv0": (h, w, cin, c[0]), "conv1": (h, w, c[0], c[1]),
            "res1a": (h // 2, w // 2, c[1], c[1]),
            "res1b": (h // 2, w // 2, c[1], c[1]),
            "conv2": (h // 2, w // 2, c[1], c[2]),
            "conv3": (h // 4, w // 4, c[2], c[3]),
            "res2a": (h // 8, w // 8, c[3], c[3]),
            "res2b": (h // 8, w // 8, c[3], c[3])}


def kn2col_calls(sizes: Dict, batch: int) -> Iterable[Tuple[str, int, int, int]]:
    """(layer, rows, codebooks, columns) of every LUT-MU tap call of one
    Kn2col forward of ``batch`` images, in launch order (9 a layer)."""
    d_sub = sizes["lutmu"]["d_sub"]
    for name, (h, w, cin, cout) in resnet9_convs(sizes).items():
        if name in sizes["exact_layers"]:
            continue
        for _ in range(9):
            yield name, batch * h * w, cin // d_sub, cout

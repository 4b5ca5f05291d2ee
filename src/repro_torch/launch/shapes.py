"""The assigned input-shape cells and per-arch applicability policy, as in
``repro.launch.shapes``.

4 shapes × 10 archs = 40 cells.  ``long_500k`` requires sub-quadratic
attention: it runs for SSM / hybrid / sliding-window archs and is a
documented skip for pure full-attention archs; whisper's decoder is
448-token by construction so its long cell is skipped too.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# archs with sub-quadratic attention paths (SSM / hybrid / sliding-window)
LONG_CONTEXT_OK = {
    "mamba2-370m",          # SSM: O(1) decode state
    "jamba-1.5-large-398b",  # hybrid: mamba + 1/8 attention (seq-sharded KV)
    "gemma3-27b",           # 5:1 local:global sliding window
    "gemma3-4b",
    "mixtral-8x7b",         # SWA throughout
}


def cell_is_applicable(arch: str, shape: str) -> Tuple[bool, Optional[str]]:
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        if arch == "whisper-tiny":
            return False, "enc-dec with 448-token decoder; no 500k decode"
        return False, "pure full-attention arch; long_500k needs sub-quadratic"
    return True, None


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """``meta`` tensors standing in for every model input of this cell (the
    JAX package's ``ShapeDtypeStruct``s): shapes and dtypes, no data."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    b = cell.global_batch
    if cell.kind in ("train", "prefill"):
        specs = {"tokens": meta((b, cell.seq_len), torch.int32)}
        if cell.kind == "train":
            specs["labels"] = meta((b, cell.seq_len), torch.int32)
        if cfg.is_encdec or cfg.family == "vlm":
            specs["frontend"] = meta((b, cfg.num_frontend_tokens, cfg.d_model),
                                     torch.bfloat16)
        return specs
    # decode: one new token against a seq_len KV/SSM cache
    return {"token": meta((b, 1), torch.int32), "pos": meta((), torch.int32)}

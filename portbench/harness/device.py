"""The card a run uses: its kernels built or loaded, and its description
in the result line."""
from __future__ import annotations

from typing import Dict


def build_kernels(device: str) -> None:
    """Build (first run in a checkout) or load the program's CUDA kernels,
    as set-up."""
    if device == "cuda":
        from repro_torch.kernels import _build
        for name in _build.SOURCES:
            _build.library(name)


def describe(chips: int, device: str) -> Dict:
    """``device`` of the result line; on the card its name, the cards the
    cell uses and the peak of allocated memory so far."""
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}

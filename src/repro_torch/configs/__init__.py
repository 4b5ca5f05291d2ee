"""Architecture registry: ``--arch <id>`` resolution for the port's launchers.

The ten architectures of the JAX package's registry, copied as data: the
same published numbers and the same ``reduced()`` twins.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "qwen2.5-32b": "repro_torch.configs.qwen25_32b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large",
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[name])
    return mod.reduced() if reduced else mod.CONFIG

"""Architecture registry: ``--arch <id>`` resolution for the port's launchers.

The port serves the dense paged path first, so only ``qwen3-14b`` is
registered; the other architectures join with their families.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[name])
    return mod.reduced() if reduced else mod.CONFIG

"""``load_engine`` — the serving factory (``source=None`` for now).

The port of ``repro.serving.loader.load_engine``: with no source it serves
``params`` as given — dense MLPs, or LUT-MU MLPs when ``cfg.amm.enabled``
— through the paged :class:`ServeEngine`.  Artifact and bundle sources,
speculative ones included, need the artifact reader (ROADMAP A4) and raise
until it is ported.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import ServeEngine

_ENGINE_CHOICES = ("auto", "paged")


def load_engine(source, params: dict, cfg: ModelConfig, *,
                engine: str = "auto", speculative: Optional[bool] = None,
                **opts) -> ServeEngine:
    """Build a serving engine; every keyword in ``opts`` goes to
    :class:`ServeEngine` (``max_batch``, ``max_len``, ``page_size``,
    ``prefill_chunk``, ``num_pages``, ``prefix_cache``, ``compute_dtype``,
    ``device``)."""
    if engine == "fixed":
        raise NotImplementedError(
            "the fixed-slot engine is not ported yet (ROADMAP A10)")
    if engine not in _ENGINE_CHOICES:
        raise ValueError(
            f"engine must be one of {_ENGINE_CHOICES}, got {engine!r}")
    if speculative:
        raise NotImplementedError(
            "speculative serving from load_engine takes a (target, draft) "
            "artifact pair or a bundle, which needs the artifact reader "
            "(ROADMAP A4); build a SpeculativeEngine from params directly")
    if source is not None:
        raise NotImplementedError(
            f"serving from an artifact or bundle ({source!r}) needs the "
            "artifact reader, which is not ported yet (ROADMAP A4)")
    return ServeEngine(params, cfg, **opts)

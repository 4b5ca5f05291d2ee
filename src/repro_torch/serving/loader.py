"""``load_engine`` — the one serving factory (``repro.serving.loader``).

Sniffs what ``source`` is and picks the engine:

====================================  =====================================
``source``                            engine
====================================  =====================================
``None``                              family dispatch over ``params`` as
                                      given: the paged :class:`ServeEngine`
                                      when the family has a paged KV
                                      layout, else :class:`FixedSlotEngine`
path to an ``amm_lm`` artifact        paged/fixed engine serving the
                                      artifact's LUT-MU tables
path to a target+draft bundle         :class:`SpeculativeEngine` (or the
                                      bundle's target half with
                                      ``speculative=False``)
a loaded ``Artifact`` object          same as an ``amm_lm`` path
``(target_art, draft_art)`` pair      :class:`SpeculativeEngine` from
                                      in-memory artifacts
====================================  =====================================

``engine=`` overrides the paged/fixed choice (``"auto"`` | ``"paged"`` |
``"fixed"``; the fixed engine takes ``max_batch`` as its ``slots`` and
drops the paged-only knobs).  Every other keyword goes to the engine
(``max_batch``, ``max_len``, ``page_size``, ``prefill_chunk``,
``num_pages``, ``prefix_cache``, ``compute_dtype``, ``device``,
``verify_backend``, ``spec_k``, ``recorder``, ``mesh``): every engine
built gets the same ``recorder``.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from repro_torch.compiler.artifact import peek_manifest
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import (FixedSlotEngine, ServeEngine,
                                        _family_engine, _splice_artifact,
                                        _fixed_kwargs)
from repro_torch.serving.speculative import SpeculativeEngine

_ENGINE_CHOICES = ("auto", "paged", "fixed")


def _is_pathlike(source) -> bool:
    return isinstance(source, (str, os.PathLike))


def _is_artifact(source) -> bool:
    # a loaded Artifact, of either package's reader (duck-typed)
    return hasattr(source, "kind") and hasattr(source, "manifest")


def _paged_or_fixed(engine: str, params: dict, cfg: ModelConfig, opts):
    if engine == "fixed":
        return FixedSlotEngine(params, cfg, **_fixed_kwargs(opts))
    if engine == "paged":
        return ServeEngine(params, cfg, **opts)
    return _family_engine(params, cfg, **opts)


def _load_artifact_path(path, params: dict, cfg: ModelConfig, engine: str,
                        opts):
    # auto resolves by the family (splicing only turns the AMM path on)
    if engine == "auto":
        engine = "paged" if MD.supports_paged(cfg) else "fixed"
    if engine == "paged":
        return ServeEngine._from_artifact(path, params, cfg, **opts)
    return FixedSlotEngine._from_artifact(path, params, cfg,
                                          **_fixed_kwargs(opts))


def load_engine(source, params: dict, cfg: ModelConfig, *,
                engine: str = "auto", speculative: Optional[bool] = None,
                **opts):
    """Build a serving engine from ``source`` (see module docstring).

    ``engine`` forces paged/fixed dispatch; ``speculative`` controls what
    a bundle becomes (default True → :class:`SpeculativeEngine`; False →
    the bundle's target half through the paged/fixed engine).  ``params`` is always the dense-model tree that
    artifacts were compiled against.
    """
    if engine not in _ENGINE_CHOICES:
        raise ValueError(
            f"engine must be one of {_ENGINE_CHOICES}, got {engine!r}")
    device = opts.get("device", "cuda")

    # (target, draft) in-memory artifact pair → speculative
    if isinstance(source, (tuple, list)):
        if len(source) != 2:
            raise ValueError(
                f"artifact-pair source must be (target, draft), got "
                f"{len(source)} elements")
        if speculative is False:
            t_params, t_cfg = _splice_artifact(source[0], params, cfg, device,
                                               opts.get("mesh"))
            return _paged_or_fixed(engine, t_params, t_cfg, opts)
        return SpeculativeEngine._from_artifacts(source[0], source[1],
                                                 params, cfg, **opts)

    # a single loaded artifact object → splice
    if _is_artifact(source):
        s_params, s_cfg = _splice_artifact(source, params, cfg, device,
                                           opts.get("mesh"))
        return _paged_or_fixed(engine, s_params, s_cfg, opts)

    # a path → sniff the manifest kind
    if _is_pathlike(source):
        kind = peek_manifest(source).get("kind")
        if kind == "bundle":
            if speculative is False:
                return _load_artifact_path(Path(source) / "target", params,
                                           cfg, engine, opts)
            return SpeculativeEngine._from_bundle(source, params, cfg, **opts)
        if kind == "amm_lm":
            if speculative:
                raise ValueError(
                    "speculative=True needs a target+draft bundle source, "
                    f"got an {kind!r} artifact — compile one with "
                    "`python -m repro_torch.compiler bundle`")
            return _load_artifact_path(source, params, cfg, engine, opts)
        raise ValueError(
            f"cannot serve artifact kind {kind!r} from {source!r}")

    # no source → serve params as given
    if source is None:
        if speculative:
            raise ValueError(
                "speculative=True needs a bundle path or an artifact pair "
                "as source")
        return _paged_or_fixed(engine, params, cfg, opts)

    raise TypeError(
        f"unsupported source {type(source).__name__!r}: expected None, a "
        "path, a loaded Artifact, or a (target, draft) pair")

"""The offline compiler's runtime half: artifact reading and writing, and
the LUT resolution configs (``repro.compiler``'s ``artifact`` and part of
``quantize``).

Calibration, planning and the LUT fit are still to port (ROADMAP A12);
:func:`pack_amm_lm` packs per-layer AMM-MLP tables that are already fitted
(or drawn at random for a smoke run) into an ``amm_lm`` artifact.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.compiler.artifact import (  # noqa: F401
    ARTIFACT_FORMAT,
    ARTIFACT_VERSION,
    BUNDLE_VERSION,
    PLATFORM,
    Artifact,
    ArtifactError,
    load_artifact,
    load_bundle,
    peek_manifest,
    save_artifact,
    save_bundle,
)
from repro_torch.compiler.quantize import (  # noqa: F401
    RESOLUTIONS,
    ResolutionConfig,
    get_resolution,
    pack_int4,
    unpack_int4,
)


def pack_amm_lm(fitted: list, cfg, resolution: str,
                name: Optional[str] = None,
                mesh_shape: Optional[dict] = None) -> Artifact:
    """Per-layer AMM-MLP param dicts of numpy arrays (int4 tables as int8
    codes in ``[-8, 7]``) → an in-memory ``amm_lm`` artifact, as the JAX
    compiler packs them: int4 LUTs ship two codes per byte, with each
    table's true column count in the manifest's ``int4_cols``."""
    tensors = {}
    int4_cols = {}
    lut_bytes = 0
    for i, d in enumerate(fitted):
        for k, v in d.items():
            arr = np.asarray(v)
            is_lut = (k.startswith("lut_") and "scale" not in k
                      and "offset" not in k)
            if is_lut and resolution == "int4":
                int4_cols[f"layer{i}/{k}"] = int(arr.shape[-1])
                arr = pack_int4(arr)
            tensors[f"layer{i}/{k}"] = arr
            if is_lut:
                lut_bytes += arr.nbytes
    a = cfg.amm
    manifest = {
        "format": ARTIFACT_FORMAT,
        "version": ARTIFACT_VERSION,
        "kind": "amm_lm",
        "name": name or f"{cfg.name}-amm",
        "arch": cfg.name,
        "platform": PLATFORM,
        "resolution": resolution,
        "num_layers": int(cfg.num_layers),
        "amm": {"d_sub": a.d_sub, "depth": a.depth, "prune": a.prune,
                "quantize_int8": resolution != "float32",
                "backend": a.backend},
        "resource_report": {"lut_bytes": int(lut_bytes)},
    }
    if int4_cols:
        manifest["int4_cols"] = int4_cols
    if mesh_shape is not None:
        manifest["mesh"] = {k: int(v) for k, v in mesh_shape.items()}
    return Artifact(manifest=manifest, tensors=tensors)

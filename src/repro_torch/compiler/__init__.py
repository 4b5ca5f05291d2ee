"""The offline LUT-MU compiler: calibrate → prune → quantise → pack, as
``repro.compiler``.

  1. **calibrate** (``compiler.calibrate``) — fit per-layer MADDNESS hash
     trees, ridge-optimised prototypes and float LUTs from dense weights
     plus calibration data, in torch on the data's device (the card from
     the CLI by default);
  2. **plan** (``compiler.planner``) — wire the paper's pruning across
     consecutive layers and fix per-layer backends and launch plans;
  3. **quantise** (``compiler.quantize``) — bake LUT entries at a
     resolution config (float32 / int16 / int8 / int4-packed);
  4. **pack** (``compiler.artifact``) — the versioned, checksummed
     artifact directory both packages read.

``python -m repro_torch.compiler`` drives it from the command line.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

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
    tiles_to_json,
)
from repro_torch.compiler.calibrate import (  # noqa: F401
    ACTIVATIONS,
    CalibrationConfig,
    LayerCalibration,
    calibrate_chain,
    calibrate_layer,
    calibrate_lm_mlp_layers,
    calibrate_lm_mlp_layers_float,
)
from repro_torch.compiler.planner import LayerPlan, plan_chain  # noqa: F401
from repro_torch.compiler.quantize import (  # noqa: F401
    RESOLUTIONS,
    ResolutionConfig,
    get_resolution,
    pack_int4,
    quantize_lut,
    resource_report,
    unpack_int4,
)
from repro_torch.core import lut_mu as LM
from repro_torch.core import maddness as M
from repro_torch.device import StageClock, stage


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def pack_amm_lm(fitted: list, cfg, resolution: str,
                name: Optional[str] = None,
                mesh_shape: Optional[dict] = None) -> Artifact:
    """Per-layer AMM-MLP param dicts of arrays or tensors (int4 tables as
    int8 codes in ``[-8, 7]``) → an in-memory ``amm_lm`` artifact of numpy
    arrays, as the JAX compiler packs them: int4 LUTs ship two codes per
    byte, with each table's true column count in the manifest's
    ``int4_cols``."""
    tensors = {}
    int4_cols = {}
    lut_bytes = 0
    for i, d in enumerate(fitted):
        for k, v in d.items():
            arr = _np(v)
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


@dataclasses.dataclass
class CompileResult:
    """What one ``compile_chain`` / ``compile_lm_amm`` call produced."""

    artifact: Artifact
    chain: Optional[LM.AMMChain]  # in-memory servable chain (amm_chain kind)
    path: Optional[Path]          # artifact dir when ``out`` was given
    report: dict                  # resolution-config resource report


def compile_chain(weights: Sequence, biases: Sequence, calib_x, *,
                  num_codebooks: Sequence[int], depths: Sequence[int],
                  activations: Sequence[Optional[str]] = (),
                  resolution: str = "float32", prune: bool = True,
                  batch_hint: int = 256, autotune: bool = False,
                  calibration: CalibrationConfig = CalibrationConfig(),
                  name: str = "amm_chain", out: Optional[str] = None,
                  device=None) -> CompileResult:
    """Compile a dense cascade into a servable LUT-MU artifact on
    ``device`` (default: ``calib_x``'s).

    Calibrate each layer on propagated approximate activations, plan the
    pruned hand-offs and launch plans for the card, quantise at
    ``resolution`` (numpy, the JAX package's arithmetic), and (when
    ``out`` is given) pack to disk.  The returned in-memory ``chain`` and a
    reload of ``out`` are built from identical arrays."""
    res = get_resolution(resolution)
    calibs = calibrate_chain(weights, biases, calib_x, num_codebooks, depths,
                             activations, config=calibration, device=device)
    dev = calibs[0].params.lut.device
    plans = plan_chain(calibs, res, prune=prune, batch_hint=batch_hint,
                       autotune=autotune, device=dev)
    tensors = {}
    layer_recs = []
    shapes = []
    chain_layers = []
    for i, (cal, plan) in enumerate(zip(calibs, plans)):
        lut = _np(cal.params.lut).astype(np.float32)
        offset = _np(cal.params.lut_offset).astype(np.float32)
        if plan.prune_plan is not None:
            keep = _np(plan.prune_plan.keep_idx)
            lut, offset = lut[..., keep], offset[..., keep]
            tensors[f"layer{i}/keep_idx"] = keep.astype(np.int32)
        int4_packed = False
        if res.is_float:
            q = lut
            scale = np.ones((lut.shape[-1],), np.float32)
        else:
            q, scale, offset = quantize_lut(lut, offset, res.bits)
            if res.bits == 4:
                q = pack_int4(q)
                int4_packed = True
        tensors[f"layer{i}/split_dims"] = _np(cal.params.tree.split_dims
                                              ).astype(np.int32)
        tensors[f"layer{i}/thresholds"] = _np(cal.params.tree.thresholds
                                              ).astype(np.float32)
        tensors[f"layer{i}/lut"] = q
        tensors[f"layer{i}/lut_scale"] = scale
        tensors[f"layer{i}/lut_offset"] = np.asarray(offset, np.float32)
        layer_recs.append({
            "num_codebooks": cal.num_codebooks,
            "depth": cal.depth,
            "in_features": cal.in_features,
            "out_features_full": cal.out_features,
            "cols": plan.cols,
            "pruned": plan.prune_plan is not None,
            "consumer_codebooks": (plan.prune_plan.consumer_codebooks
                                   if plan.prune_plan else None),
            "consumer_depth": (plan.prune_plan.consumer_depth
                               if plan.prune_plan else None),
            "backend": plan.backend,
            "tiles": tiles_to_json(plan.tiles),
            "lut_dtype": str(np.asarray(q).dtype),
            "int4_packed": int4_packed,
        })
        shapes.append((cal.num_codebooks, cal.depth, plan.cols,
                       cal.out_features))
        # the in-memory twin: the artifact's arrays, plus the calibrated
        # prototypes (for rebuilds)
        run_lut = unpack_int4(q, plan.cols) if int4_packed else q
        chain_layers.append(LM.AMMLinear(
            params=M.MaddnessParams(
                tree=cal.params.tree, prototypes=cal.params.prototypes,
                lut=torch.from_numpy(np.ascontiguousarray(run_lut)).to(dev),
                lut_scale=torch.from_numpy(scale).to(dev),
                lut_offset=torch.from_numpy(
                    np.asarray(offset, np.float32)).to(dev)),
            out_plan=plan.prune_plan,
            full_out_features=cal.out_features,
            tiles=plan.tiles))
    report = resource_report(shapes)
    acts = (tuple(activations) if activations
            else (None,) * (len(list(weights)) - 1))
    manifest = {
        "format": ARTIFACT_FORMAT,
        "version": ARTIFACT_VERSION,
        "kind": "amm_chain",
        "name": name,
        "platform": PLATFORM,
        "resolution": res.name,
        "activations": list(acts),
        "layers": layer_recs,
        "resource_report": report,
    }
    art = Artifact(manifest=manifest, tensors=tensors)
    path = save_artifact(out, art) if out is not None else None
    chain = LM.AMMChain(
        layers=chain_layers, activation_names=acts,
        backends=tuple(rec["backend"] for rec in layer_recs))
    return CompileResult(artifact=art, chain=chain, path=path, report=report)


def compile_lm_amm(params: dict, cfg, tokens, *, name: Optional[str] = None,
                   out: Optional[str] = None,
                   mesh_shape: Optional[dict] = None, seed: int = 0,
                   resolution: Optional[str] = None,
                   clock: Optional[StageClock] = None) -> CompileResult:
    """Compile an LM's MLP blocks into an ``amm_lm`` artifact.

    Captures each layer's MLP-input activations on ``tokens``, fits the
    AMM-MLP tables per layer on the params' device, quantises them at
    ``resolution`` (default: int8 when ``cfg.amm.quantize_int8``, else
    float32) and packs them.  ``mesh_shape`` records the serving mesh the
    artifact is meant for.  ``clock`` times the stages, ``write`` too."""
    if resolution is None:
        resolution = "int8" if cfg.amm.quantize_int8 else "float32"
    fitted = calibrate_lm_mlp_layers(params, cfg, tokens, seed=seed,
                                     resolution=resolution, clock=clock)
    with stage(clock, "write"):
        art = pack_amm_lm(fitted, cfg, resolution, name, mesh_shape)
        path = save_artifact(out, art) if out is not None else None
    return CompileResult(artifact=art, chain=None, path=path,
                         report=art.manifest["resource_report"])


@dataclasses.dataclass
class BundleResult:
    """What one ``compile_lm_bundle`` call produced."""

    target: Artifact              # full-resolution verifier
    draft: Artifact               # low-resolution proposer
    manifest: dict                # bundle-level manifest
    path: Optional[Path]          # bundle dir when ``out`` was given
    report: dict                  # per-half LUT bytes + draft savings


def compile_lm_bundle(params: dict, cfg, tokens, *,
                      target_resolution: str = "int8",
                      draft_resolution: str = "int4", spec_k: int = 4,
                      name: Optional[str] = None, out: Optional[str] = None,
                      mesh_shape: Optional[dict] = None, seed: int = 0,
                      clock: Optional[StageClock] = None) -> BundleResult:
    """Compile a target+draft artifact pair from **one** calibration pass:
    each layer's trees, prototypes and float tables are fitted once, then
    baked at the target's and the draft's resolution, so the draft differs
    from the target only in LUT entry width.  Load side:
    ``compiler.artifact.load_bundle`` / ``serving.load_engine``."""
    from repro_torch.models.amm_mlp import AMM_RESOLUTIONS, quantize_amm_layer

    for which, res in (("target", target_resolution),
                       ("draft", draft_resolution)):
        if res not in AMM_RESOLUTIONS:
            raise ValueError(f"{which}_resolution must be one of "
                             f"{AMM_RESOLUTIONS}, got {res!r}")
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    float_layers = calibrate_lm_mlp_layers_float(params, cfg, tokens,
                                                 seed=seed, clock=clock)
    base = name or f"{cfg.name}-spec"
    halves = {}
    for which, res in (("target", target_resolution),
                       ("draft", draft_resolution)):
        with stage(clock, "quantize"):
            layers = [quantize_amm_layer(fp, res) for fp in float_layers]
        with stage(clock, "write"):
            halves[which] = pack_amm_lm(layers, cfg, res, f"{base}-{which}",
                                        mesh_shape)
        del layers
    del float_layers
    target, draft = halves["target"], halves["draft"]
    t_bytes = target.manifest["resource_report"]["lut_bytes"]
    d_bytes = draft.manifest["resource_report"]["lut_bytes"]
    report = {
        "target": {"resolution": target_resolution, "lut_bytes": t_bytes},
        "draft": {"resolution": draft_resolution, "lut_bytes": d_bytes},
        # stored int4 codes occupy int8 at run time; count the shipped
        # width for the paper-style savings ratio
        "draft_vs_target_stored": round(t_bytes / max(d_bytes, 1), 3),
    }
    manifest = {
        "format": ARTIFACT_FORMAT,
        "version": BUNDLE_VERSION,
        "kind": "bundle",
        "name": base,
        "arch": cfg.name,
        "num_layers": int(cfg.num_layers),
        "spec_k": int(spec_k),
        "resource_report": report,
    }
    path = None
    if out is not None:
        with stage(clock, "write"):
            path = save_bundle(out, manifest, target, draft)
        manifest = peek_manifest(path)  # the sub-checksums and defaults
    return BundleResult(target=target, draft=draft, manifest=manifest,
                        path=path, report=report)

"""Servable artifact: versioned manifest + packed tensors on disk (the
reader and writer of ``repro.compiler.artifact``, same format).

An artifact directory holds

  ``manifest.json``  — format tag, schema version, kind, resolution config,
    per-layer records (shapes, dtypes, pruning metadata, the planner's
    backend/tile choices), the resource report, and the sha256 of the
    tensor file;
  ``tensors.npz``    — the packed arrays (``np.savez_compressed``; int4
    LUTs ship two entries per byte).

Writes are atomic (tmp dir + ``os.replace``), and loads are paranoid:
format/version mismatches, a corrupted tensor file (checksum), or
missing/mis-shaped arrays all raise :class:`ArtifactError` rather than
serving garbage.  An artifact written by either package loads in the other.

Two kinds:

  * ``amm_chain`` — a standalone LUT-MU cascade (``Artifact.to_chain`` →
    ``core.lut_mu.AMMChain``);
  * ``amm_lm``    — per-transformer-layer AMM-MLP params for a named arch
    (``Artifact.splice_lm_params`` swaps them into a params tree for
    ``ServeEngine``).

Tensors stay numpy arrays until ``to_chain`` / ``splice_lm_params`` put them
on the caller's device.  ``to_chain`` applies the recorded per-layer
backends and launch plans (``tiles``, a ``kernels.autotune.TileConfig``)
only when the manifest's ``platform`` is the port's own (``"cuda"``): an
artifact the JAX package wrote records TPU block shapes, which are ignored,
and re-decides each layer on ``"auto"``, as the JAX package does on a
platform other than the one it compiled for.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.compiler import quantize as Q
from repro_torch.core import lut_mu as LM
from repro_torch.core import maddness as M
from repro_torch.convert import to_tensor
from repro_torch.core import pruning as P
from repro_torch.device import resolve_device
from repro_torch.kernels import autotune as AT

ARTIFACT_FORMAT = "repro-lutmu-artifact"
ARTIFACT_VERSION = 1
# the ``bundle`` kind (a target+draft artifact pair for speculative
# decoding) is versioned on its own: a bundle directory holds its own
# manifest plus two complete sub-artifacts
BUNDLE_VERSION = 1
# the ``platform`` this package records, and whose recorded backends and
# launch plans ``to_chain`` applies
PLATFORM = AT.PLATFORM
_TENSORS_FILE = "tensors.npz"
_MANIFEST_FILE = "manifest.json"
_BUNDLE_TARGET_DIR = "target"
_BUNDLE_DRAFT_DIR = "draft"


class ArtifactError(ValueError):
    """Unloadable artifact: wrong format/version, corruption, bad schema."""


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


@dataclasses.dataclass
class Artifact:
    """A loaded (or about-to-be-saved) compiled model; ``tensors`` are
    numpy arrays."""

    manifest: dict
    tensors: Dict[str, np.ndarray]

    @property
    def kind(self) -> str:
        return self.manifest["kind"]

    @property
    def resolution(self) -> str:
        return self.manifest["resolution"]

    @property
    def resource_report(self) -> dict:
        return self.manifest.get("resource_report", {})

    # -- reconstruction ----------------------------------------------------
    def _layer_lut(self, i: int, rec: dict) -> np.ndarray:
        if rec.get("int4_packed"):
            return Q.unpack_int4(self.tensors[f"layer{i}/lut"], rec["cols"])
        return self.tensors[f"layer{i}/lut"]

    def to_chain(self, apply_recorded_backends: Optional[bool] = None, *,
                 device="cuda") -> LM.AMMChain:
        """Rebuild the servable :class:`~repro_torch.core.lut_mu.AMMChain`
        on ``device``.

        Recorded per-layer backends and launch plans are applied when the
        manifest's ``platform`` is this package's (override with
        ``apply_recorded_backends``); otherwise ``"auto"`` re-decides per
        shape and each wrapper plans its own launch.
        """
        if self.kind != "amm_chain":
            raise ArtifactError(f"kind {self.kind!r} is not an amm_chain")
        if apply_recorded_backends is None:
            apply_recorded_backends = self.manifest.get("platform") == PLATFORM
        dev = resolve_device(device)
        t = self.tensors
        layers: List[LM.AMMLinear] = []
        for i, rec in enumerate(self.manifest["layers"]):
            params = M.MaddnessParams(
                tree=M.HashTree(
                    split_dims=to_tensor(t[f"layer{i}/split_dims"], dev),
                    thresholds=to_tensor(t[f"layer{i}/thresholds"], dev)),
                prototypes=None,
                lut=to_tensor(self._layer_lut(i, rec), dev),
                lut_scale=to_tensor(t[f"layer{i}/lut_scale"], dev),
                lut_offset=to_tensor(t[f"layer{i}/lut_offset"], dev))
            plan = None
            if rec["pruned"]:
                plan = P.PruningPlan(
                    keep_idx=to_tensor(t[f"layer{i}/keep_idx"].astype(np.int64),
                                     dev),
                    consumer_codebooks=rec["consumer_codebooks"],
                    consumer_depth=rec["consumer_depth"])
            tiles = None
            if apply_recorded_backends and rec.get("tiles"):
                tiles = AT.TileConfig.from_dict(rec["tiles"])
            layers.append(LM.AMMLinear(
                params=params, out_plan=plan,
                full_out_features=rec["out_features_full"], tiles=tiles))
        backends = (tuple(rec["backend"] for rec in self.manifest["layers"])
                    if apply_recorded_backends else None)
        return LM.AMMChain(
            layers=layers,
            activation_names=tuple(self.manifest["activations"]),
            backends=backends)

    def _lm_array(self, i: int, name: str) -> np.ndarray:
        """Layer ``i``'s tensor ``name``, int4 tables unpacked to the
        runtime's int8 codes in ``[-8, 7]``."""
        key = f"layer{i}/{name}"
        v = self.tensors[key]
        cols = self.manifest.get("int4_cols", {}).get(key)
        return v if cols is None else Q.unpack_int4(v, cols)

    def _lm_names(self) -> List[str]:
        if self.kind != "amm_lm":
            raise ArtifactError(f"kind {self.kind!r} is not an amm_lm")
        return [k[len("layer0/"):] for k in self.tensors
                if k.startswith("layer0/")]

    def lm_layer_params(self, device="cuda") -> List[dict]:
        """Per-transformer-layer AMM-MLP param dicts (kind ``amm_lm``) on
        ``device``.

        int4 artifacts store their LUTs packed two-codes-per-byte (the
        manifest's ``int4_cols`` records each table's true column count);
        they are unpacked here to the runtime's int8 codes in ``[-8, 7]``.
        """
        names = self._lm_names()
        dev = resolve_device(device)
        return [{k: to_tensor(self._lm_array(i, k), dev) for k in names}
                for i in range(self.manifest["num_layers"])]

    def splice_lm_params(self, params: dict, device="cuda") -> dict:
        """Swap the compiled AMM-MLP tables into a dense LM params tree.

        Returns a new params dict whose stacked ``layers`` carry
        ``amm_mlp`` (the artifact's tables, stacked on ``device`` one layer
        at a time) instead of ``mlp`` — the form ``ServeEngine`` serves
        when ``cfg.amm.enabled``.
        """
        names = self._lm_names()
        dev = resolve_device(device)
        n_layers = self.manifest["num_layers"]
        amm = {}
        for k in names:
            first = self._lm_array(0, k)
            out = torch.empty((n_layers,) + first.shape,
                              dtype=torch.from_numpy(first[:0]).dtype,
                              device=dev)
            for i in range(n_layers):
                arr = first if i == 0 else self._lm_array(i, k)
                out[i].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            amm[k] = out
        layers = dict(params["layers"])
        layers.pop("mlp", None)
        layers["amm_mlp"] = amm
        return dict(params, layers=layers)


# ---------------------------------------------------------------------------
# Save / load.
# ---------------------------------------------------------------------------


def tiles_to_json(tiles: Optional[AT.TileConfig]) -> Optional[dict]:
    return None if tiles is None else tiles.to_dict()


def save_artifact(directory, artifact: Artifact) -> Path:
    """Atomically write ``manifest.json`` + ``tensors.npz``."""
    final = Path(directory)
    tmp = final.with_name(final.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez_compressed(tmp / _TENSORS_FILE, **artifact.tensors)
    manifest = dict(artifact.manifest)
    manifest.setdefault("format", ARTIFACT_FORMAT)
    manifest.setdefault("version", ARTIFACT_VERSION)
    manifest.setdefault("created_unix", time.time())
    manifest["tensors_sha256"] = _sha256(tmp / _TENSORS_FILE)
    (tmp / _MANIFEST_FILE).write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic commit
    artifact.manifest = manifest
    return final


def load_artifact(directory) -> Artifact:
    """Load + validate an artifact directory (raises :class:`ArtifactError`)."""
    path = Path(directory)
    manifest = peek_manifest(path)
    if manifest.get("kind") == "bundle":
        raise ArtifactError(
            f"{path} is a target+draft bundle — load it with load_bundle() "
            "(or serve it, or its target/ sub-artifact, with load_engine)")
    if manifest.get("version") != ARTIFACT_VERSION:
        raise ArtifactError(
            f"artifact version {manifest.get('version')!r} != supported "
            f"{ARTIFACT_VERSION}")
    tf = path / manifest.get("tensors_file", _TENSORS_FILE)
    if not tf.is_file():
        raise ArtifactError(f"missing tensor file {tf.name} in {path}")
    digest = _sha256(tf)
    if digest != manifest.get("tensors_sha256"):
        raise ArtifactError(
            f"tensor checksum mismatch in {path}: file {digest[:12]}… != "
            f"manifest {str(manifest.get('tensors_sha256'))[:12]}…")
    with np.load(tf) as data:
        tensors = {k: data[k] for k in data.files}
    art = Artifact(manifest=manifest, tensors=tensors)
    _validate_schema(art, path)
    return art


def _validate_schema(art: Artifact, path: Path) -> None:
    if art.kind == "amm_chain":
        for i, rec in enumerate(art.manifest.get("layers", [])):
            for key in ("split_dims", "thresholds", "lut", "lut_scale",
                        "lut_offset"):
                if f"layer{i}/{key}" not in art.tensors:
                    raise ArtifactError(
                        f"layer{i}/{key} missing from tensors in {path}")
            lut = art._layer_lut(i, rec)
            g = 2 ** rec["depth"]
            want = (rec["num_codebooks"], g, rec["cols"])
            if tuple(lut.shape) != want:
                raise ArtifactError(
                    f"layer{i} LUT shape {tuple(lut.shape)} != manifest {want}")
            if rec["pruned"] and f"layer{i}/keep_idx" not in art.tensors:
                raise ArtifactError(f"layer{i}/keep_idx missing in {path}")
    elif art.kind == "amm_lm":
        if art.manifest.get("num_layers", 0) < 1:
            raise ArtifactError(f"amm_lm artifact without layers in {path}")
    else:
        raise ArtifactError(f"unknown artifact kind {art.kind!r} in {path}")


# ---------------------------------------------------------------------------
# Bundles: a target+draft artifact pair for speculative decoding.
# ---------------------------------------------------------------------------


def peek_manifest(directory) -> dict:
    """Read a directory's manifest without tensor validation.

    Cheap kind/metadata sniffing (``launch/serve.py`` deciding between an
    ``amm_lm`` artifact and a bundle); callers that serve the tensors go
    through :func:`load_artifact` / :func:`load_bundle` for checksum and
    schema validation.
    """
    mf = Path(directory) / _MANIFEST_FILE
    if not mf.is_file():
        raise ArtifactError(f"no {_MANIFEST_FILE} in {directory}")
    try:
        manifest = json.loads(mf.read_text())
    except ValueError as e:
        raise ArtifactError(f"corrupt manifest in {directory}: {e}") from e
    if manifest.get("format") != ARTIFACT_FORMAT:
        raise ArtifactError(
            f"not a {ARTIFACT_FORMAT} (format={manifest.get('format')!r})")
    return manifest


def save_bundle(directory, manifest: dict, target: Artifact,
                draft: Artifact) -> Path:
    """Atomically write a speculative-decoding bundle.

    Layout::

        <directory>/manifest.json   kind="bundle" + sub-artifact records
        <directory>/target/         a complete amm_lm artifact
        <directory>/draft/          a complete amm_lm artifact

    The bundle manifest records each sub-artifact's resolution and tensor
    checksum so :func:`load_bundle` can detect a target/draft swapped or
    replaced behind the manifest's back.
    """
    final = Path(directory)
    tmp = final.with_name(final.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    save_artifact(tmp / _BUNDLE_TARGET_DIR, target)
    save_artifact(tmp / _BUNDLE_DRAFT_DIR, draft)
    manifest = dict(manifest)
    manifest.setdefault("format", ARTIFACT_FORMAT)
    manifest.setdefault("version", BUNDLE_VERSION)
    manifest["kind"] = "bundle"
    manifest.setdefault("created_unix", time.time())
    for key, art in (("target", target), ("draft", draft)):
        rec = dict(manifest.get(key, {}))
        rec["path"] = {"target": _BUNDLE_TARGET_DIR,
                       "draft": _BUNDLE_DRAFT_DIR}[key]
        rec["resolution"] = art.resolution
        rec["tensors_sha256"] = art.manifest["tensors_sha256"]
        manifest[key] = rec
    (tmp / _MANIFEST_FILE).write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic commit
    return final


def load_bundle(directory):
    """Load + validate a bundle → ``(target, draft, manifest)``.

    Both sub-artifacts go through :func:`load_artifact`'s checks
    (format/version/checksum/schema), plus bundle-level ones: recorded
    sub-checksums match the loaded tensors, both halves are ``amm_lm``
    artifacts, and they describe the same architecture and depth (the
    verify step routes both models through one page table, so a geometry
    mismatch would corrupt the KV cache rather than merely mispredict).
    """
    path = Path(directory)
    manifest = peek_manifest(path)
    if manifest.get("kind") != "bundle":
        raise ArtifactError(
            f"{path} is kind {manifest.get('kind')!r}, not a bundle")
    if manifest.get("version") != BUNDLE_VERSION:
        raise ArtifactError(
            f"bundle version {manifest.get('version')!r} != supported "
            f"{BUNDLE_VERSION}")
    arts = {}
    for key in ("target", "draft"):
        rec = manifest.get(key)
        if not isinstance(rec, dict) or "path" not in rec:
            raise ArtifactError(f"bundle manifest lacks a {key!r} record "
                                f"in {path}")
        art = load_artifact(path / rec["path"])
        if art.kind != "amm_lm":
            raise ArtifactError(
                f"bundle {key} is kind {art.kind!r}, expected amm_lm")
        if art.manifest.get("tensors_sha256") != rec.get("tensors_sha256"):
            raise ArtifactError(
                f"bundle {key} checksum drifted from the bundle manifest in "
                f"{path} — was the sub-artifact replaced?")
        arts[key] = art
    t, d = arts["target"], arts["draft"]
    for field in ("arch", "num_layers"):
        if t.manifest.get(field) != d.manifest.get(field):
            raise ArtifactError(
                f"bundle halves disagree on {field}: target "
                f"{t.manifest.get(field)!r} vs draft "
                f"{d.manifest.get(field)!r}")
    return t, d, manifest

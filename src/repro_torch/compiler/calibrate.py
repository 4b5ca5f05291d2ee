"""Offline calibration: fit per-layer MADDNESS trees + prototypes + LUTs,
as ``repro.compiler.calibrate``.

The first stage of the LUT-MU compiler.  Given trained weights and
calibration activations it produces one *unpruned, float* set of
``MaddnessParams`` per layer — the raw material the planner prunes and the
quantiser packs.  It runs in torch on the device of the calibration input.

Chain calibration follows the paper's layer-wise order: stage *i*'s trees
are fitted on the **approximate** activations propagated through the
already-fitted stages 0..i-1, with ridge-regression prototypes (MADDNESS
§4.2) on by default.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import maddness as M
from repro_torch.device import StageClock, stage

# elementwise hand-off ops — dimension-preserving, so pruning commutes
# (paper §V-A1); "gelu" is the tanh approximation, as jax.nn.gelu's default
ACTIVATIONS = {
    None: lambda v: v,
    "relu": F.relu,
    "gelu": lambda v: F.gelu(v, approximate="tanh"),
    "silu": F.silu,
}


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """Knobs of the offline fit (all layers share them)."""

    ridge_lambda: float = 1.0        # prototype ridge regulariser
    optimize_prototypes: bool = True  # full-width ridge vs bucket means
    seed: int = 0


@dataclasses.dataclass
class LayerCalibration:
    """One layer's fitted (unpruned, float) LUT-MU parameters + metadata."""

    params: M.MaddnessParams   # float32 LUT, bias folded into lut_offset
    in_features: int
    out_features: int
    activation: Optional[str]  # elementwise op applied AFTER this layer

    @property
    def num_codebooks(self) -> int:
        return self.params.tree.num_codebooks

    @property
    def depth(self) -> int:
        return self.params.tree.depth


def calibrate_layer(calib_x, weight, bias, num_codebooks: int, depth: int,
                    activation: Optional[str] = None,
                    config: CalibrationConfig = CalibrationConfig(),
                    seed_offset: int = 0, device=None) -> LayerCalibration:
    """Fit one layer on ``device`` (default: ``calib_x``'s): trees → ridge
    prototypes → float LUT."""
    params = M.fit_maddness(
        calib_x, weight, num_codebooks, depth=depth, bias=bias,
        quantize_int8=False, optimize_prototypes=config.optimize_prototypes,
        ridge_lambda=config.ridge_lambda, seed=config.seed + seed_offset,
        device=device)
    return LayerCalibration(params=params, in_features=int(weight.shape[0]),
                            out_features=int(weight.shape[1]),
                            activation=activation)


def calibrate_chain(weights: Sequence, biases: Sequence, calib_x,
                    num_codebooks: Sequence[int], depths: Sequence[int],
                    activations: Sequence[Optional[str]] = (),
                    config: CalibrationConfig = CalibrationConfig(),
                    device=None) -> List[LayerCalibration]:
    """Fit a cascade layer by layer on propagated approximate activations.

    ``activations[i]`` sits between stage *i* and *i+1*; unknown names
    raise.  Returns unpruned calibrations — chain pruning is the planner's
    job, and is lossless."""
    n_layers = len(weights)
    acts = tuple(activations) if activations else (None,) * (n_layers - 1)
    if len(acts) != n_layers - 1:
        raise ValueError(
            f"{n_layers} layers need {n_layers - 1} activations, got {len(acts)}")
    for a in acts:
        if a not in ACTIVATIONS:
            raise ValueError(f"unknown activation {a!r}")
    out: List[LayerCalibration] = []
    x = M.as_tensor(calib_x, torch.float64, device)
    for i in range(n_layers):
        act = acts[i] if i < n_layers - 1 else None
        cal = calibrate_layer(x, weights[i], biases[i], num_codebooks[i],
                              depths[i], activation=act, config=config,
                              seed_offset=i)
        out.append(cal)
        if i < n_layers - 1:
            y = M.maddness_matmul(x.to(torch.float32), cal.params)
            x = ACTIVATIONS[act](y).to(torch.float64)
    return out


def capture_lm_mlp_inputs(params: dict, cfg, tokens) -> List[torch.Tensor]:
    """Per-layer MLP-input activations of an LM on sample tokens, float64
    on the params' device (``models.model.capture_mlp_inputs`` at float32
    compute)."""
    from repro_torch.models import model as MD

    caps = MD.capture_mlp_inputs(params, tokens, cfg,
                                 compute_dtype=torch.float32)
    return [c.to(torch.float64) for c in caps]


def calibrate_lm_mlp_layers_float(params: dict, cfg, tokens, seed: int = 0, *,
                                  clock: Optional[StageClock] = None
                                  ) -> List[dict]:
    """Fit **float32** AMM-MLP params for every transformer layer from the
    activations each layer receives, on the params' device.  The
    resolution-independent pass: ``models.amm_mlp.quantize_amm_layer``
    bakes it at any resolution (the bundle compiler bakes it twice, so
    target and draft share their trees).  ``clock`` times ``capture`` and
    the fit's stages."""
    from repro_torch.models import amm_mlp as AMM
    from repro_torch.models.model import layer_params

    with stage(clock, "capture"):
        caps = capture_lm_mlp_inputs(params, cfg, tokens)
    fitted = []
    for l, acts in enumerate(caps):
        mlp = layer_params(params["layers"], l)["mlp"]
        fitted.append(AMM.fit_from_dense_float(
            acts, mlp["w_gate"], mlp["w_up"], mlp["w_down"], cfg,
            seed=seed + l, clock=clock))
    return fitted


def calibrate_lm_mlp_layers(params: dict, cfg, tokens, seed: int = 0,
                            resolution: Optional[str] = None, *,
                            clock: Optional[StageClock] = None) -> List[dict]:
    """Fit AMM-MLP params for every transformer layer and quantise them at
    ``resolution`` (default: int8 when ``cfg.amm.quantize_int8``, else
    float32); one dict per layer, keyed per ``amm_mlp_param_shapes``."""
    from repro_torch.models import amm_mlp as AMM

    if resolution is None:
        resolution = "int8" if cfg.amm.quantize_int8 else "float32"
    fitted = calibrate_lm_mlp_layers_float(params, cfg, tokens, seed=seed,
                                           clock=clock)
    with stage(clock, "quantize"):
        return [AMM.quantize_amm_layer(fp, resolution) for fp in fitted]

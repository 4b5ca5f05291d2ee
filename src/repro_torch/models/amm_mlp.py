"""LUT-MU MLP (PyTorch): the gated MLP's three projections as pruned LUT-MU
approximate matmuls, as in ``repro.models.amm_mlp``.

    x ──encode(up-tree)──┬──► lut_gate ─┐ silu·mul   (pruned packages)
                         └──► lut_up   ─┘    │
                                             ▼
          package ──encode(down-tree)──► lut_down ──► full d_model

Gate and up share one tree, so the split values are gathered once for
both; the down projection reads the cluster-ordered pruned package.
Gate/up LUTs are parameter-pruned to the down encode's split dims.
:func:`fit_from_dense` fits these params from calibration activations
(on their device), :func:`quantize_amm_layer` bakes one fit at a
resolution config.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import lut_mu as LU
from repro_torch.core import maddness as M
from repro_torch.core import pruning as P
from repro_torch.device import StageClock, stage
from repro_torch.kernels import dispatch as D
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def amm_mlp_param_shapes(cfg: ModelConfig, dtype=torch.int8) -> dict:
    """name → (shape, dtype) of one layer's AMM-MLP params."""
    d, ff = cfg.d_model, cfg.d_ff
    a = cfg.amm
    g = 2 ** a.depth
    c_up = d // a.d_sub
    c_down = ff // a.d_sub
    cols = a.depth * c_down if a.prune else ff  # pruned gate/up output
    f32, i32 = torch.float32, torch.int32
    return {
        "up_split_dims": ((c_up, a.depth), i32),
        "up_thresholds": ((c_up, g - 1), f32),
        "lut_gate": ((c_up, g, cols), dtype),
        "lut_gate_scale": ((cols,), f32),
        "lut_gate_offset": ((cols,), f32),
        "lut_up": ((c_up, g, cols), dtype),
        "lut_up_scale": ((cols,), f32),
        "lut_up_offset": ((cols,), f32),
        "down_split_dims": ((c_down, a.depth), i32),
        "down_thresholds": ((c_down, g - 1), f32),
        "lut_down": ((c_down, g, d), dtype),
        "lut_down_scale": ((d,), f32),
        "lut_down_offset": ((d,), f32),
    }


def init_amm_mlp_params(cfg: ModelConfig, gen: torch.Generator,
                        dtype=torch.int8) -> dict:
    """Random-but-valid AMM params, made on the generator's device (smoke
    runs; real tables come from the offline fit)."""
    out = {}
    dev = gen.device
    for name, (shape, dt) in amm_mlp_param_shapes(cfg, dtype).items():
        if "split" in name:
            out[name] = torch.randint(0, cfg.amm.d_sub, shape, generator=gen,
                                      dtype=dt, device=dev)
        elif dt == torch.int8:
            out[name] = torch.randint(-128, 128, shape, generator=gen,
                                      dtype=dt, device=dev)
        elif "scale" in name:
            out[name] = torch.full(shape, 0.01, dtype=dt, device=dev)
        else:
            out[name] = torch.randn(shape, generator=gen, dtype=dt,
                                    device=dev).mul_(0.1)
    return out


def _params(p: dict, tree: str, proj: str) -> M.MaddnessParams:
    return D.params_from_arrays(p[f"{tree}_split_dims"], p[f"{tree}_thresholds"],
                                p[f"lut_{proj}"], p[f"lut_{proj}_scale"],
                                p[f"lut_{proj}_offset"])


def amm_mlp_apply(params: dict, x: Tensor, cfg: ModelConfig,
                  par=None) -> Tensor:
    """(B, S, D) → (B, S, D) through the pruned LUT-MU MLP chain; every
    matmul goes through ``dispatch.lutmu_matmul`` with ``cfg.amm.backend``.

    On a mesh (``par``, a ``distributed.sharding.ParallelContext``) the
    tables are this rank's codebook shards and every matmul runs through
    ``dispatch.lutmu_matmul_sharded``: per-shard partials summed over
    ``model``, so no table is ever gathered.  Gate and up still share the
    split-value gather (this rank's codebooks); the down projection reads
    the whole pruned package."""
    b, s, d = x.shape
    be = cfg.amm.backend
    if par is None:
        def matmul(v, p, kind, c):
            return D.lutmu_matmul(v, p, backend=be, input_kind=kind)
    else:
        def matmul(v, p, kind, c):
            return D.lutmu_matmul_sharded(v, p, mesh=par.mesh, backend=be,
                                          input_kind=kind, codebooks=c,
                                          comm=par.comm)
    c_up, c_down = cfg.d_model // cfg.amm.d_sub, cfg.d_ff // cfg.amm.d_sub
    gate_p = _params(params, "up", "gate")
    up_p = _params(params, "up", "up")
    xt = x.reshape(b * s, d).to(torch.float32)
    if par is not None and par.tp > 1 and c_up % par.tp == 0:
        xs = D.local_split_values(xt, gate_p, par.tp_rank, c_up)
    else:
        xs = M.gather_split_values(xt, gate_p.tree)
    gate = matmul(xs, gate_p, "split", c_up)
    up = matmul(xs, up_p, "split", c_up)
    h = F.silu(gate) * up
    # gate/up emitted the cluster-ordered pruned package when pruning is on
    down_kind = "package" if cfg.amm.prune else "full"
    down_p = _params(params, "down", "down")
    out = matmul(h, down_p, down_kind, c_down)
    if LU._PROBE_TAP is not None and par is None:
        # quality-probe tap: eager calls only (the probe's replay), never
        # inside a captured step program
        LU._tap_eager("gate", xs, gate_p, gate, "split")
        LU._tap_eager("up", xs, up_p, up, "split")
        LU._tap_eager("down", h, down_p, out, down_kind)
    return out.reshape(b, s, d).to(x.dtype)


# Resolution configs the amm_lm runtime can serve: float32 tables go
# through the float contraction, int8 through the integer-accumulation
# path, and int4 codes are stored as int8 in [-8, 7] (same runtime path,
# the speculative-decoding draft setting).
AMM_RESOLUTIONS = ("float32", "int8", "int4")


def fit_from_dense_float(calib_x, w_gate, w_up, w_down, cfg: ModelConfig,
                         seed: int = 0, *,
                         clock: Optional[StageClock] = None) -> dict:
    """Fit one layer's AMM-MLP params with **float32** LUTs, on the device
    of ``calib_x`` (a tensor; an array fits on the CPU).

    The resolution-independent half of the offline fit: trees, prototypes
    and pruned float tables; :func:`quantize_amm_layer` bakes them at any
    entry width, so one calibration pass gives e.g. an int8 target and an
    int4 draft with identical trees.  The down tree is fitted on the exact
    activations ``silu(x @ W_gate) * (x @ W_up)``: the products in float64
    rounded to float32, as the JAX package computes them; ``silu`` is
    evaluated in float64 and rounded, so the CPU and the card (whose
    float32 ``exp`` differ in the last bit) fit the same tree.  ``clock``
    times the stages ``trees``, ``h_full``, ``up_solve``, ``down_solve``
    and ``lut_build``.
    """
    a = cfg.amm
    x = M.as_tensor(calib_x, torch.float64)
    dev = x.device
    d, ff = w_gate.shape
    c_up, c_down = d // a.d_sub, ff // a.d_sub
    with stage(clock, "trees"):
        up_tree = M.learn_hash_trees(x, c_up, a.depth, seed=seed)
    with stage(clock, "up_solve"):
        protos = M.learn_prototypes(x, up_tree)
    with stage(clock, "h_full"):
        g = (x @ M.as_tensor(w_gate, torch.float64, dev)).to(torch.float32)
        u = (x @ M.as_tensor(w_up, torch.float64, dev)).to(torch.float32)
        h_full = F.silu(g.to(torch.float64)).to(torch.float32) * u
        del g, u
    with stage(clock, "trees"):
        down_tree = M.learn_hash_trees(h_full, c_down, a.depth, seed=seed + 1)
    with stage(clock, "down_solve"):
        protos_d = M.learn_prototypes(h_full, down_tree)
    del h_full
    plan = (P.plan_from_consumer_tree(down_tree, consumer_in_dim=ff)
            if a.prune else None)

    def build(protos_, w, consumer_plan):
        lut, scale, offset = M.build_lut(
            protos_, M.as_tensor(w, torch.float32, dev), quantize_int8=False)
        if consumer_plan is not None:
            lut, offset = P.prune_lut(lut, offset, consumer_plan)
        n = lut.shape[-1]
        return lut, scale.expand(n).contiguous(), offset.expand(n).contiguous()

    with stage(clock, "lut_build"):
        lut_g, sg, og = build(protos, w_gate, plan)
        lut_u, su, ou = build(protos, w_up, plan)
        del protos
        lut_d, sd_, od = build(protos_d, w_down, None)
    return {
        "up_split_dims": up_tree.split_dims,
        "up_thresholds": up_tree.thresholds,
        "lut_gate": lut_g, "lut_gate_scale": sg, "lut_gate_offset": og,
        "lut_up": lut_u, "lut_up_scale": su, "lut_up_offset": ou,
        "down_split_dims": down_tree.split_dims,
        "down_thresholds": down_tree.thresholds,
        "lut_down": lut_d, "lut_down_scale": sd_, "lut_down_offset": od,
    }


def quantize_amm_layer(float_params: dict, resolution: str) -> dict:
    """Bake one layer's float AMM-MLP tables at a resolution config.

    The MADDNESS quantisation is per-column separable, so quantising after
    pruning equals pruning after quantising, bit for bit."""
    if resolution not in AMM_RESOLUTIONS:
        raise ValueError(f"amm_lm resolution must be one of {AMM_RESOLUTIONS},"
                         f" got {resolution!r} (int16 has no integer LUT "
                         "runtime path)")
    if resolution == "float32":
        return dict(float_params)
    bits = 8 if resolution == "int8" else 4
    out = dict(float_params)
    for proj in ("gate", "up", "down"):
        q, scale, offset = M.quantize_lut_bits(
            float_params[f"lut_{proj}"], bits=bits,
            bias=float_params[f"lut_{proj}_offset"])
        out[f"lut_{proj}"] = q
        out[f"lut_{proj}_scale"] = scale
        out[f"lut_{proj}_offset"] = offset
    return out


def fit_from_dense(calib_x, w_gate, w_up, w_down, cfg: ModelConfig,
                   seed: int = 0, resolution: Optional[str] = None) -> dict:
    """Offline-fit AMM-MLP params from calibration activations, quantised at
    ``resolution`` (default: int8 when ``cfg.amm.quantize_int8``, else
    float32)."""
    if resolution is None:
        resolution = "int8" if cfg.amm.quantize_int8 else "float32"
    fp = fit_from_dense_float(calib_x, w_gate, w_up, w_down, cfg, seed=seed)
    return quantize_amm_layer(fp, resolution)

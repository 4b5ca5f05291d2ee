"""LUT-MU MLP (PyTorch): the gated MLP's three projections as pruned LUT-MU
approximate matmuls, as in ``repro.models.amm_mlp``.

    x ──encode(up-tree)──┬──► lut_gate ─┐ silu·mul   (pruned packages)
                         └──► lut_up   ─┘    │
                                             ▼
          package ──encode(down-tree)──► lut_down ──► full d_model

Gate and up share one tree, so the split values are gathered once for
both; the down projection reads the cluster-ordered pruned package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import lut_mu as LU
from repro_torch.core import maddness as M
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


def amm_mlp_apply(params: dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    """(B, S, D) → (B, S, D) through the pruned LUT-MU MLP chain; every
    matmul goes through ``dispatch.lutmu_matmul`` with ``cfg.amm.backend``."""
    b, s, d = x.shape
    be = cfg.amm.backend
    gate_p = _params(params, "up", "gate")
    up_p = _params(params, "up", "up")
    xs = M.gather_split_values(x.reshape(b * s, d).to(torch.float32),
                               gate_p.tree)
    gate = D.lutmu_matmul(xs, gate_p, backend=be, input_kind="split")
    up = D.lutmu_matmul(xs, up_p, backend=be, input_kind="split")
    h = F.silu(gate) * up
    # gate/up emitted the cluster-ordered pruned package when pruning is on
    down_kind = "package" if cfg.amm.prune else "full"
    down_p = _params(params, "down", "down")
    out = D.lutmu_matmul(h, down_p, backend=be, input_kind=down_kind)
    if LU._PROBE_TAP is not None:
        # quality-probe tap: eager calls only (the probe's replay), never
        # inside a captured step program
        LU._tap_eager("gate", xs, gate_p, gate, "split")
        LU._tap_eager("up", xs, up_p, up, "split")
        LU._tap_eager("down", h, down_p, out, down_kind)
    return out.reshape(b, s, d).to(x.dtype)

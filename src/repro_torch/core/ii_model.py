"""Analytic initiation-interval / resource model of the LUT-MU (paper Fig. 7).

The FPGA hardware quantities (clock-level II, ROM count, adder trees, power)
do not transfer to a GPU, but the paper's design-space trade-off — partition
factors ``(S, E)`` against II and resources — is reproduced here as the
analytic model used by ``benchmarks/bench_fig13_pareto.py``.  This is a
copy of ``repro.core.ii_model``: pure arithmetic, no framework.

Model (Section V-C2):
  * allocate+encode bottleneck:    ``α · I_i``            (per input vector)
  * aggregate/ROM-read bottleneck: ``α · S_i · E_i``       (read blocking)
  * II = max of the two.
Resources:
  * ROMs       = (I' · C' · C) / (S · E)   (distributed dual-port ROM group)
  * adder trees = I' · C' / E
  * comparator-array encoders = C / S
Power proxy: affine in resources (fitted to the paper's Fig. 13 scale).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LutMuConfig:
    c_in: int          # C_i  — input codebooks
    depth_in: int      # I_i
    c_out: int         # C_{i+1}
    depth_out: int     # I_{i+1}
    s: int = 2         # partition factor S (S/2 must divide C_in)
    e: int = 1         # partition factor E (must divide C_out * I_out)
    alpha: float = 1.0  # average cycles per elementary op

    def validate(self) -> None:
        if self.s % 2 or self.c_in % (self.s // 2) if self.s > 1 else False:
            raise ValueError("S/2 must divide C_in")
        if (self.c_out * self.depth_out) % self.e:
            raise ValueError("E must divide C_out * I_out")


def initiation_interval(cfg: LutMuConfig) -> float:
    """Cycles between successive input vectors (paper Fig. 7)."""
    encode_ii = cfg.alpha * cfg.depth_in
    aggregate_ii = cfg.alpha * cfg.s * cfg.e
    return max(encode_ii, aggregate_ii)


def resources(cfg: LutMuConfig) -> dict:
    roms = (cfg.depth_out * cfg.c_out * cfg.c_in) / (cfg.s * cfg.e)
    adders = cfg.depth_out * cfg.c_out / max(cfg.e, 1)
    encoders = cfg.c_in / max(cfg.s, 1)
    lut_entries = cfg.c_in * (2 ** cfg.depth_in) * (cfg.depth_out * cfg.c_out)
    return {
        "roms": roms,
        "adder_trees": adders,
        "encoders": encoders,
        "lut_entries": lut_entries,
    }


def power_proxy_mw(cfg: LutMuConfig, *, static_mw: float = 60.0,
                   mw_per_rom: float = 0.12, mw_per_adder: float = 0.35,
                   mw_per_encoder: float = 0.8) -> float:
    """Affine resource→power proxy calibrated to the paper's Fig. 13 range
    (LUT-MU points span roughly 100–400 mW on XCZU7EV@100 MHz)."""
    r = resources(cfg)
    return (static_mw + mw_per_rom * r["roms"] + mw_per_adder * r["adder_trees"]
            + mw_per_encoder * r["encoders"])


def throughput_fps(cfg: LutMuConfig, f_clk_hz: float = 100e6) -> float:
    """FPS = F_clk / II (paper Eq. 5)."""
    return f_clk_hz / initiation_interval(cfg)

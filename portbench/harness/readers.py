"""Arithmetic shared by the metric readers in ``portbench/metrics``."""
from __future__ import annotations

from typing import Dict, Optional

from portbench import counts as K
from portbench.harness import stats as S
from portbench.harness import trace as T


def mfu(ctx: Dict) -> Optional[float]:
    """Dense-equivalent model FLOPs of the window's work over the busy step
    time at the bf16 peak, in %."""
    if not ctx.get("busy_s") or "model_flops" not in ctx:
        return None
    return 100.0 * ctx["model_flops"] / (ctx["busy_s"] * K.PEAK_BF16_FLOPS)


def lutmu_roofline(ctx: Dict) -> Optional[float]:
    """Σ bound ÷ Σ device time of the traced slice's ``fused_lutmu``
    launches, in %."""
    tr, bound = ctx.get("device_trace"), ctx.get("lutmu_bound_ms")
    if tr is None or not bound:
        return None
    dev_s, launches = T.kernel_time_s(tr, "fused_lutmu")
    if not launches:
        return None
    return 100.0 * bound / (1e3 * dev_s)


def device_idle(ctx: Dict) -> Optional[float]:
    """Share of the traced slice with no kernel, copy or set running, in %."""
    tr = ctx.get("device_trace")
    if tr is None:
        return None
    return 100.0 * (1.0 - T.busy_s(tr) / T.window_s(tr))


def mean_of(ctx: Dict, key: str, sub: Optional[str] = None) -> Optional[float]:
    vals = ctx.get(key)
    if vals is not None and sub is not None:
        vals = vals.get(sub)
    return S.mean(vals) if vals else None


def percentile_of(ctx: Dict, key: str, q: float) -> Optional[float]:
    vals = ctx.get(key)
    return S.percentile(vals, q) if vals else None

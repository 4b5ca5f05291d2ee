"""Driver of the image-classification cells: the port's model forward
(the configuration's ``program_forward``) over a device pool of seeded
image batches, forward after forward with no host synchronisation inside
the window; the window closes when the forwards enqueued in ``seconds``
have all completed.  ``images_s`` counts their images over the window.

Correctness: after the window, the logits of a seeded sample of the
window's forwards are compared with the reference's logits of the same
batches; the compared number is the largest absolute difference over the
reference's largest magnitude.
"""
from __future__ import annotations

import importlib
import time
from typing import Dict, List

import torch

from portbench import counts as K
from portbench.harness import device as D
from portbench.harness import result as R
from portbench.harness import trace as T
from portbench.harness import traffic as TR

TRACE_FORWARDS = 20    # forwards under the profiler after a traced window


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> R.Outcome:
    mod, sizes, mix = cell.config, cell.sizes, cell.mix
    on_card = device == "cuda"
    D.build_kernels(device)
    batch, n_pool = mix["batch"], mix["pool_batches"]
    params = mod.make_params(sizes, seed, device)
    pool = mod.make_images(sizes, seed, n_pool, batch, device)
    forward = mod.program_forward(params)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    outs: List = []
    with torch.inference_mode():
        for k in range(mix["warmup_forwards"]):
            forward(pool[k % n_pool])
        sync()
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            outs.append(forward(pool[len(outs) % n_pool]))
        sync()
        w1 = time.perf_counter()
        n = len(outs)
        profiled = None
        if trace and on_card:
            def forwards(k):
                return lambda: [forward(pool[i % n_pool]) for i in range(k)]
            profiled = T.run_slice(torch, forwards(3), forwards(TRACE_FORWARDS))
    dev = D.describe(cell.chips, device)
    ctx: Dict = {"setup_s": w0 - t_start, "window_s": w1 - w0,
                 "busy_s": w1 - w0, "images": n * batch,
                 "model_flops": n * batch * K.resnet9_image_flops(sizes)}

    # -- the reference over a sample of the window's forwards ---------------
    ref = importlib.import_module(f"portbench.reference.{mod.REFERENCE}")
    pick = sorted(TR.rng(seed, "check").permutation(n)[:mix["check_forwards"]])
    seen = K.TableRows(2 ** sizes["lutmu"]["depth"]) if trace else None
    codes = seen
    problems: List[str] = []
    worst = 0.0
    with torch.inference_mode():
        for k in pick:
            got = outs[k]
            if not bool(torch.isfinite(got).all()):
                problems.append(f"forward {k}: non-finite logits")
            want = ref.forward(params, pool[k % n_pool], codes)
            worst = max(worst, _rel_err(got, want))
            codes = None  # one forward's codes are enough for the bound
    checks = {"logit_err": R.Check(worst, float(cell.limits["logit_err"]))}
    dev_trace = T.reduce(profiled) if profiled is not None else None
    if dev_trace is not None:
        dev["busy_s"] = T.busy_s(dev_trace)
        dev["window_s"] = T.window_s(dev_trace)
        ctx["device_trace"] = dev_trace
        ctx["lutmu_bound_ms"] = _lutmu_bound_ms(sizes, batch, seen,
                                                TRACE_FORWARDS)
    return R.Outcome(ctx=ctx, attempted=n * batch, failed=0, checks=checks,
                     problems=problems, device=dev,
                     breakdown=T.breakdown(dev_trace) if dev_trace else None,
                     check_inputs=(params, [pool[k % n_pool] for k in pick]))


def control(cell, outcome: R.Outcome, device: str) -> float:
    """The control's reading on a run's own batches: the reference with the
    operands of its exact products rounded to TF32 (the precision below
    float32 with TF32 off), against the reference."""
    params, batches = outcome.check_inputs
    ref = importlib.import_module(f"portbench.reference.{cell.config.REFERENCE}")
    worst = 0.0
    with torch.inference_mode():
        for x in batches:
            lo = ref.forward(params, x, operand=ref.tf32)
            worst = max(worst, _rel_err(lo, ref.forward(params, x)))
    return worst


def _rel_err(got, want) -> float:
    """Largest absolute difference of two batches' logits over the
    reference's largest magnitude."""
    return float((got - want).abs().max() / want.abs().max())


def _lutmu_bound_ms(sizes: Dict, batch: int, seen: K.TableRows,
                    forwards: int):
    """Σ bound of the traced slice's LUT-MU launches: ``forwards`` Kn2col
    forwards, each tap at the share of table rows the reference's codes
    for calls of its shape read."""
    depth = sizes["lutmu"]["depth"]
    g = 2 ** depth
    total = 0.0
    for _, rows, c, n in K.kn2col_calls(sizes, batch):
        share = seen.share(rows, c)
        if share is None:
            return None
        total += K.lutmu_bound_ms(rows, c, n, depth, 1, share * c * g)[0]
    return forwards * total

#!/usr/bin/env python3
"""Time the port's verify-window, fused LUT-MU, encode and LUT-aggregate
kernels of one source tree three ways, at the shapes ``chip_smoke.py``
uses:

    python3 tools/kernel_timing.py [--src DIR] [--label NAME] [--sweep]
                                   [--kernels NAME,...]

``--src`` is a ``src`` directory holding ``repro_torch`` (default: this
checkout's), so the kernels of another commit can be timed in the same
call (unpack it with ``git archive`` into a directory ``.gitignore``
lists).  Inputs and the event timer come from this checkout's
``chip_smoke.py``, so both trees see the same data.  Per case it prints one
JSON line with

* ``event_ms`` — CUDA events around single calls queued behind a device
  sleep, L2 flushed before each (``chip_smoke.Timer``);
* ``device_ms`` — the kernels' own time per call from ``torch.profiler``
  (only kernels of the wrapper's library, flush excluded);
* ``host_blocked_ms`` — host time of one wrapper call issued while the
  device still runs a 25 ms sleep: near 0 when the call only enqueues,
  near the sleep when something in it waits for the device.

``encode_onehot`` is timed with float32 output and, in the int8 cases,
int8 output (what the unfused path asks for with int8 tables); its line
also names the launch plan where the tree's wrapper has ``plan``.  A first
``encode_onehot`` line at B=1, C=1 is the kernel's fixed cost.
``--kernels`` times only the named kernels (``verify_window``,
``decode_read``, ``fused_lutmu``, ``encode_onehot``, ``lut_aggregate``).
``decode_read`` is the verify kernel at W = 1, the paged decode step's
read, at ``chip_smoke.DECODE_SHAPE`` and ``DECODE_S`` (bf16 pages), under
every split count the card runs and the one the tree's wrapper plans.

``--sweep`` times only ``fused_lutmu``, under every cluster size (of a
tree whose wrapper has ``launch``), beside the plan ``fused_lutmu.plan``
picks.

Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def host_blocked_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms of device work ahead of the call
    t0 = time.perf_counter()
    fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3


def lut_cases(torch, CS):
    """``chip_smoke.CASES``' LUT-MU inputs, one case at a time, from one
    seeded generator: (projection, B, LUT type, (x, thr, lut, scale,
    offset))."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    g = 2**CS.DEPTH
    for proj, b, lut_name in CS.CASES:
        c, n = CS.SHAPES[proj]
        dt = {"int8": torch.int8, "int16": torch.int16,
              "float32": torch.float32, "bfloat16": torch.bfloat16}[lut_name]
        x = torch.randn((b, c, CS.DEPTH), generator=gen, device="cuda")
        thr = torch.randn((c, g - 1), generator=gen, device="cuda")
        if dt == torch.int8:
            lut = torch.randint(-128, 128, (c, g, n), generator=gen,
                                dtype=torch.int8, device="cuda")
        elif dt == torch.int16:
            lut = torch.randint(-2**15, 2**15, (c, g, n), generator=gen,
                                dtype=torch.int16, device="cuda")
        else:
            lut = torch.randn((c, g, n), generator=gen, device="cuda").to(dt)
        scale = torch.rand((n,), generator=gen, device="cuda") * 0.015 + 0.005
        offset = torch.randn((n,), generator=gen, device="cuda")
        yield proj, b, lut_name, (x, thr, lut, scale, offset)
        del x, thr, lut
        torch.cuda.empty_cache()


def sweep(torch, CS, FL, timer, report) -> int:
    """Event ms of ``fused_lutmu`` under every cluster size, each output
    checked against the picked plan's."""
    for proj, b, lut_name, args in lut_cases(torch, CS):
        lut = args[2]
        c, n = lut.shape[0], lut.shape[-1]
        itemsize = lut.element_size()
        picked = FL._plan_for(b, c, n, CS.DEPTH, lut.dtype, 0)
        want = FL.fused_lutmu(*args)
        for cs in range(1, FL.MAX_CLUSTER + 1):
            p = FL.sized(b, c, CS.DEPTH, itemsize, cs)
            got = FL.launch(*args, launch_plan=p)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            report(kernel="fused_lutmu", case=f"{proj} B={b} {lut_name}",
                   cluster=cs, k_stage=p.k_stage, picked=p == picked,
                   max_abs_err=err,
                   event_ms=timer.ms(lambda: FL.launch(*args, launch_plan=p), 10))
        report(kernel="fused_lutmu", case=f"{proj} B={b} {lut_name}",
               plan=str(picked), event_ms=timer.ms(lambda: FL.fused_lutmu(*args), 20))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--kernels", default="verify_window,decode_read,"
                    "fused_lutmu,encode_onehot,lut_aggregate")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    import torch
    if not torch.cuda.is_available():
        print("kernel_timing: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as CS
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_lutmu as FL
    from repro_torch.kernels import fused_verify as FV
    from repro_torch.kernels import lut_aggregate as LA
    from repro_torch.kernels import maddness_encode as ME

    _build.build()
    timer = CS.Timer(torch)
    tiny = torch.zeros(1, device="cuda")
    timer.ms(tiny.zero_, 20)  # the process's first timed calls read high
    kind = torch.cuda.get_device_name(0)

    def report(**kw):
        print(json.dumps(dict(label=args.label, device=kind, **kw)), flush=True)

    if args.sweep:
        return sweep(torch, CS, FL, timer, report)
    device_ms = CS.device_ms
    gen = torch.Generator(device="cuda").manual_seed(4321)
    for s_len in CS.VERIFY_S if "verify_window" in kernels else ():
        for kv_name in ("bfloat16", "float32", "int8"):
            q, kp, vp, pt, pos = CS.verify_inputs(torch, s_len, kv_name, gen)
            fn = lambda: FV.verify_window_attend_cuda(q, kp, vp, pt, pos, None)  # noqa: E731
            report(kernel="verify_window", case=f"S={s_len} {kv_name}",
                   event_ms=timer.ms(fn, 20),
                   device_ms=device_ms(torch, fn, ["verify_window"], 20,
                                       timer.flush),
                   host_blocked_ms=host_blocked_ms(torch, fn))
            del q, kp, vp, pt, pos

    for s_len, lo in CS.DECODE_S if "decode_read" in kernels else ():
        q, kp, vp, pt, pos = CS.decode_inputs(torch, s_len, lo, "bfloat16", gen)
        b, nkv, g, hd, ps = CS.DECODE_SHAPE
        planned = FV.heuristic_splits(b, 1, nkv, g, hd, ps, s_len, kp.dtype)
        for splits in range(1, 9):
            if FV.max_clusters(kp.dtype, 1, g, hd, ps, splits,
                               FV.split_cap(s_len, splits)) < 1:
                continue
            fn = lambda n=splits: FV.verify_window_attend_cuda(  # noqa: E731
                q, kp, vp, pt, pos, None, splits=n)
            report(kernel="decode_read", case=f"S={s_len} bfloat16",
                   splits=splits, planned=splits == planned,
                   event_ms=timer.ms(fn, 20),
                   device_ms=device_ms(torch, fn, ["verify_window"], 20,
                                       timer.flush))
        del q, kp, vp, pt, pos

    sms = _build.sm_count()
    if "encode_onehot" in kernels:
        x1 = torch.zeros((1, 1, CS.DEPTH), device="cuda")
        t1 = torch.zeros((1, 2**CS.DEPTH - 1), device="cuda")
        fn = lambda: ME.encode_onehot(x1, t1)  # noqa: E731
        report(kernel="encode_onehot", case="B=1 C=1 (fixed cost)",
               out=str(torch.float32), event_ms=timer.ms(fn, 20),
               device_ms=device_ms(torch, fn, ["encode_onehot"], 20,
                                   timer.flush),
               host_blocked_ms=host_blocked_ms(torch, fn))
    for proj, b, lut_name, (x, thr, lut, scale, offset) in lut_cases(torch, CS):
        case = f"{proj} B={b} {lut_name}"
        if "fused_lutmu" in kernels:
            fn = lambda: FL.fused_lutmu(x, thr, lut, scale, offset)  # noqa: E731
            report(kernel="fused_lutmu", case=case, event_ms=timer.ms(fn, 20),
                   device_ms=device_ms(torch, fn, ["fused_lutmu", "reduce_epilogue"],
                                       20, timer.flush),
                   host_blocked_ms=host_blocked_ms(torch, fn))
        outs = (torch.float32, torch.int8) if lut.dtype == torch.int8 else (torch.float32,)
        for od in outs if "encode_onehot" in kernels else ():
            fn = lambda od=od: ME.encode_onehot(x, thr, out_dtype=od)  # noqa: E731
            plan = getattr(ME, "plan", None)
            extra = ({"plan": str(plan(b, lut.shape[0], CS.DEPTH,
                                       od.itemsize, sms))} if plan else {})
            report(kernel="encode_onehot", case=case, out=str(od),
                   event_ms=timer.ms(fn, 20),
                   device_ms=device_ms(torch, fn, ["encode_onehot"], 20,
                                       timer.flush),
                   host_blocked_ms=host_blocked_ms(torch, fn), **extra)
        if "lut_aggregate" in kernels:
            onehot = ME.encode_onehot_plain(x, thr)
            fn = lambda: LA.lut_aggregate(onehot, lut, scale, offset)  # noqa: E731
            report(kernel="lut_aggregate", case=case, event_ms=timer.ms(fn, 10),
                   device_ms=device_ms(torch, fn, ["lut_aggregate", "reduce_epilogue"],
                                       10, timer.flush),
                   host_blocked_ms=host_blocked_ms(torch, fn))
            del onehot
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The device trace of a traced run: ``torch.profiler`` over a slice of
steady-state work, reduced to kernel intervals, the device's busy time, its
idle gaps labelled by what the host was doing, and time by kernel name.

The slice follows the measured window, under the same traffic, so the
profiler's cost (its start, its stop, CUPTI on every launch) stays out of
the window; it starts after a device synchronisation and ends with one
inside the ``portbench.slice`` host range, so every kernel it launched
lies inside it.  The harness labels its own host phases with ``record_function``
ranges (``harness.*`` and ``program.*``, the latter around each call of a
serving step program); a gap takes the label of the innermost range that
holds its midpoint.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "portbench.slice"
NAME_CHARS = 160  # kernel names in the breakdown are cut to this length


def run_slice(torch, warm: Callable[[], None], body: Callable[[], None]):
    """Run ``warm`` and then ``body`` under the profiler, only ``body``
    inside the slice (the profiler's own start-up stays out of it);
    returns the profiler, whose trace :func:`reduce` reads later."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm()
        torch.cuda.synchronize()
        with record_function(SLICE):
            body()
            torch.cuda.synchronize()
    return prof


def reduce(prof) -> Dict:
    """The profiler's trace, reduced (:func:`reduce_events`); it is written
    to a temporary file and read back."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce_events(events)


def reduce_events(events: List[Dict]) -> Dict:
    """Chrome trace events → ``{"slice": (t0, t1) µs, "kernels": [(name,
    ts, dur)], "ranges": [(name, ts, dur)]}`` within the slice."""
    sl = [e for e in events if e.get("name") == SLICE
          and e.get("cat") == "user_annotation"]
    if not sl:
        raise RuntimeError("the profiler trace holds no portbench.slice range")
    t0 = float(sl[0]["ts"])
    t1 = t0 + float(sl[0]["dur"])
    kernels, ranges = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            if ts + dur > t0 and ts < t1:
                kernels.append((e["name"], max(ts, t0), min(ts + dur, t1) - max(ts, t0)))
        elif (e.get("cat") == "user_annotation" and e["name"] != SLICE
              and ts < t1 and ts + dur > t0):
            ranges.append((e["name"], ts, dur))
    kernels.sort(key=lambda k: k[1])
    return {"slice": (t0, t1), "kernels": kernels, "ranges": ranges}


def busy_intervals(kernels) -> List[Tuple[float, float]]:
    """The union of the kernels' intervals, merged and sorted (µs)."""
    merged: List[List[float]] = []
    for _, ts, dur in sorted(kernels, key=lambda k: k[1]):
        end = ts + dur
        if merged and ts <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([ts, end])
    return [(a, b) for a, b in merged]


def busy_s(tr: Dict) -> float:
    return sum(b - a for a, b in busy_intervals(tr["kernels"])) / 1e6


def window_s(tr: Dict) -> float:
    t0, t1 = tr["slice"]
    return (t1 - t0) / 1e6


def gaps(tr: Dict) -> List[Tuple[float, float]]:
    """Idle intervals of the device inside the slice (µs)."""
    t0, t1 = tr["slice"]
    out, at = [], t0
    for a, b in busy_intervals(tr["kernels"]):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if t1 > at:
        out.append((at, t1))
    return out


def label(tr: Dict, t: float) -> str:
    """The innermost harness range holding host time ``t``."""
    best = None
    for name, ts, dur in tr["ranges"]:
        if ts <= t <= ts + dur and (best is None or dur < best[1]):
            best = (name, dur)
    return best[0] if best else "outside any harness range"


def breakdown(tr: Dict, top: int = 10) -> Dict:
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing (seconds)."""
    by_name: Dict[str, float] = {}
    for name, _, dur in tr["kernels"]:
        key = name[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(tr), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[label(tr, (a + b) / 2), (b - a) / 1e6]
                          for a, b in idle]}


def kernel_time_s(tr: Dict, fragment: str) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds
    ``fragment``."""
    hits = [dur for name, _, dur in tr["kernels"] if fragment in name]
    return sum(hits) / 1e6, len(hits)

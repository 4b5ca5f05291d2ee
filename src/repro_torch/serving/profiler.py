"""Kernel-level profiler for the port's serving engines, as
``repro.serving.profiler``.

Answers "where does device time go inside a step" without breaking the
recorder's zero-overhead-off contract:

  * **Sampled timed steps** — the engine calls :meth:`KernelProfiler.tick`
    once per step; every ``every``-th step becomes a *profiled* step.  On
    a profiled step the engine routes its decode and prefill calls
    through :meth:`timed`, which names the call's site.  On the card each
    step-program call of a profiled step records a pair of CUDA events on
    its stream, from inside the program (``programs.py``: before its
    input copy and after its replay, so no wrapper around the program
    hides them), and hands them here; nothing waits for them.  Each
    :meth:`tick` resolves the pairs whose end event has completed
    (``query()``), :meth:`flush` the rest with one sync (the exports
    call it).  A resolved pair observes its device seconds in the per-site
    histogram (``kernel_latency_seconds{site=...}``, the calls
    :meth:`timed` ran) and becomes a span on the ``kernels`` tracer lane
    (``Tracer.KERNEL_TID``) named by site, or by the program's name for
    the untimed calls of the step (the samplers), with the engine's step
    index in ``args``; a timed callable that hands no pair (a wrapper
    around eager code) is timed by a pair recorded around it.  The spans
    sit on the recorder's clock through an anchor: one event recorded
    beside a host clock read after a device sync, when the profiler is
    attached and at ``Recorder.reset()`` (:meth:`anchor`); each span is
    placed from the previous one's end event, so the gaps between calls
    keep the events' precision.  On the CPU a timed call is bracketed by
    the host clock.  A program not
    captured yet is captured first (``StepProgram.build``): the first
    profiled call times a replay, never a capture.  With the profiler off
    the hook sites reduce to the usual ``if obs:`` check, and profiling
    every step costs a few event records and queries, no sync.

  * **Program cost** — once per (site, input-shape signature), the
    program's ``cost`` function (set by the engine from the config and the
    input shapes, running nothing: a call would write the KV cache) fills
    ``kernel_flops{site=...}`` / ``kernel_bytes{site=...}``.  These counts
    are the port's own (:func:`forward_cost`), not XLA's cost analysis,
    though the gauges keep the JAX package's names and help strings.

  * **Dispatch-site counters** — :func:`attach_dispatch_hook` installs a
    hook in ``kernels.dispatch`` that counts LUT-MU backend selections on
    static call metadata (``lutmu_dispatch_total{backend=...,
    input_kind=...}``).  Dispatch runs in Python only when a step program
    builds (its capture on the card, its first call on the CPU), so the
    counter counts built programs, and adds nothing per replayed step.

Streams are unaffected: timing wraps calls whose results the engine was
about to consume anyway (``tests/test_torch_obs.py``).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pruning import workload_ops
from repro_torch.models.config import ModelConfig
from repro_torch.serving.obs import MetricsRegistry, Tracer, log

__all__ = ["KernelProfiler", "attach_dispatch_hook", "forward_cost"]

# µs-scale kernel latencies need finer buckets than request latencies
KERNEL_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3,
                  5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0)
# the least gap between two kernels-lane spans: back-to-back calls share
# an event timestamp, and one lane's spans must not overlap
_LANE_GAP_S = 1e-8


def _device_of(fn) -> torch.device:
    """The device a timed callable runs on: its own ``device`` where it
    has one (a step program), else the card once CUDA has started."""
    device = getattr(fn, "device", None)
    if device is not None:
        return device
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    return torch.device("cuda" if cuda else "cpu")


def forward_cost(cfg: ModelConfig, *, rows: int, tokens: int, ctx: int,
                 head_tokens: int, kv_itemsize: int,
                 param_bytes: int) -> Tuple[int, int]:
    """``(flops, bytes)`` of one paged forward of ``rows`` batch rows, each
    feeding ``tokens`` positions that attend ``ctx`` cache positions (the
    gathered page view), with the LM head at ``head_tokens`` positions.

    Flops: per token and layer, the Q/K/V/O projections ``2·D·hd·(2·Hq +
    2·Hkv)``, attention ``4·Hq·hd·ctx``, and the MLP — dense ``6·D·F``,
    or on LUT-MU the paper's online op count (``core/pruning.py::
    workload_ops``) of gate, up and down; the head ``2·D·V`` per head
    token.  Norms and elementwise ops are left out.  Bytes: every
    parameter read once, the cache view read and the new K/V written, and
    the float32 logits written.
    """
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    a = cfg.amm
    if a.enabled and "mlp" in a.targets:
        c_up, c_down = d // a.d_sub, cfg.d_ff // a.d_sub
        cols = a.depth * c_down if a.prune else cfg.d_ff
        mlp = (2 * workload_ops(c_up, a.depth, cols)
               + workload_ops(c_down, a.depth, d))
    else:
        mlp = 6 * d * cfg.d_ff
    per_token = 2 * d * hd * (2 * nq + 2 * nkv) + 4 * nq * hd * ctx + mlp
    flops = rows * (tokens * cfg.num_layers * per_token
                    + head_tokens * 2 * d * cfg.vocab_size)
    kv = rows * cfg.num_layers * 2 * (ctx + tokens) * nkv * hd * kv_itemsize
    logits = rows * head_tokens * cfg.vocab_size * 4
    return flops, param_bytes + kv + logits


class KernelProfiler:
    """Sampling kernel profiler; attach to a live recorder as
    ``rec.profiler`` (engines pick it up via ``obs.profiler``)."""

    def __init__(self, registry: MetricsRegistry, *,
                 tracer: Optional[Tracer] = None, every: int = 16,
                 clock=time.perf_counter):
        if every < 1:
            raise ValueError(f"profile every must be >= 1, got {every}")
        self.registry = registry
        self.tracer = tracer
        self.every = int(every)
        self.active = False
        self._clock = clock
        self._step = 0
        self._hists: Dict[str, object] = {}
        self._cost_done: set = set()
        self._c_steps = registry.counter(
            "kernel_profiled_steps_total", "Engine steps profiled")
        self._site: Optional[str] = None  # the site ``timed`` is running
        self._paired = False              # its program handed events
        # [site, timed, step, start, end, drained] in stream order
        self._pending: deque = deque()
        # (event, host seconds) the next resolved span is placed from
        self._base: Optional[tuple] = None
        self._lane_end = float("-inf")

    # -- the device clock ----------------------------------------------------
    def anchor(self) -> None:
        """Tie the device's event clock to the host clock: sync the device,
        record one event and read the clock beside it.  Drops the calls not
        resolved yet.  Runs at attach and at ``Recorder.reset()``, outside
        any measured window; a no-op until CUDA has started."""
        self._pending.clear()
        self._base, self._lane_end = None, float("-inf")
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._base = (ev, self._clock())
        ev.synchronize()

    def start_event(self, device) -> Optional["torch.cuda.Event"]:
        """An unrecorded start event for a step-program call on
        ``device``, or None where the call is not timed by events (an
        unprofiled step, the CPU).  The program records it before its
        input copy and hands it back through :meth:`program_call`."""
        if not self.active or device.type != "cuda":
            return None
        if self._base is None:
            self.anchor()  # attached before CUDA started: one sync, once
        return torch.cuda.Event(enable_timing=True)

    def program_call(self, name: str, start) -> None:
        """Record the end event of a program call whose ``start`` was
        recorded; the pair waits in stream order until it resolves."""
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        timed = self._site is not None
        self._paired |= timed
        self._pending.append([self._site if timed else name, timed,
                              self._step, start, end, False])

    def end_step(self, has_work: bool) -> None:
        """The engine's profiled step ended.  One that left the engine
        without work marks its last call ``drained``: the device gap after
        it is the engine waiting for requests, not host work between
        steps."""
        if not has_work and self._pending and (
                self._pending[-1][2] == self._step):
            self._pending[-1][5] = True

    def _resolve(self, wait: bool) -> None:
        pending = self._pending
        while pending:
            site, timed, step, start, end, drained = pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            pending.popleft()
            dur = start.elapsed_time(end) / 1e3
            if timed:
                self._hist(site).observe(dur)
            base_ev, base_t = self._base
            t0 = max(base_t + base_ev.elapsed_time(start) / 1e3,
                     self._lane_end + _LANE_GAP_S)
            self._lane_end = t0 + dur
            self._base = (end, self._lane_end)
            if self.tracer is not None:
                args = {"step": step, "drained": True} if drained else {
                    "step": step}
                self.tracer.span(Tracer.KERNEL_TID, site, t0, t0 + dur,
                                 **args)

    def flush(self) -> None:
        """Resolve every pending call, waiting for the device once (the
        pairs complete in stream order)."""
        self._resolve(wait=True)

    # -- sampling ------------------------------------------------------------
    def tick(self) -> bool:
        """Resolve the calls the device has finished, advance the step
        counter; returns (and latches) whether the step that is about to
        run is a profiled one."""
        if self._pending:
            self._resolve(wait=False)
        self._step += 1
        self.active = self._step % self.every == 0
        if self.active:
            self._c_steps.inc()
        return self.active

    # -- the timed wrapper ---------------------------------------------------
    def _hist(self, site: str):
        h = self._hists.get(site)
        if h is None:
            h = self.registry.histogram(
                "kernel_latency_seconds",
                "Device latency of profiled jitted dispatches by site",
                buckets=KERNEL_BUCKETS, site=site)
            self._hists[site] = h
        return h

    def timed(self, site: str, fn, **arrays):
        """Run ``fn(**arrays)`` (a step program, or a wrapper of one) as
        ``site``.  On the card the program's own event pair times it when
        it resolves; where ``fn`` hands none (a wrapper around eager code)
        a pair recorded here around the call does, so the histogram always
        holds device seconds.  On the CPU the host clock around the call
        times it.  Call ONLY inside a profiled step (``self.active``)."""
        self._maybe_cost(site, fn, arrays)
        build = getattr(fn, "build", None)
        if build is not None:
            build(**arrays)  # a capture is not a sample
        self._site, self._paired = site, False
        own = self.start_event(_device_of(fn))
        if own is not None:
            own.record()
        t0 = self._clock()
        try:
            out = fn(**arrays)
            if own is not None and not self._paired:
                self.program_call(site, own)
        finally:
            self._site = None
        if not self._paired:
            t1 = self._clock()
            self._hist(site).observe(t1 - t0)
            if self.tracer is not None:
                self.tracer.span(Tracer.KERNEL_TID, site, t0, t1)
        return out

    # -- program cost --------------------------------------------------------
    @staticmethod
    def _signature(arrays) -> Tuple:
        def leaf_sig(x):
            if hasattr(x, "shape") and hasattr(x, "dtype"):
                return (tuple(x.shape), str(x.dtype))
            return type(x).__name__  # a host scalar: its type, not value

        return tuple((k, leaf_sig(v)) for k, v in sorted(arrays.items()))

    def _maybe_cost(self, site: str, fn, arrays) -> None:
        """FLOPs / bytes gauges of the program behind this (site,
        signature), computed once from its ``cost`` function; a program
        without one, or a cost that raises, leaves the gauges unset
        rather than perturbing serving."""
        key = (site,) + self._signature(arrays)
        if key in self._cost_done:
            return
        self._cost_done.add(key)
        cost = getattr(fn, "cost", None)
        if cost is None:
            return
        try:
            flops, nbytes = cost(arrays)
            self.registry.gauge(
                "kernel_flops", "XLA cost-analysis FLOPs of the compiled "
                "program at a profiled site", site=site).set(float(flops))
            self.registry.gauge(
                "kernel_bytes", "XLA cost-analysis bytes accessed of the "
                "compiled program at a profiled site", site=site).set(
                    float(nbytes))
        except Exception as e:  # noqa: BLE001 — observation must not kill serving
            log("profiler", f"cost unavailable for {site}: {e!r}",
                level="debug")

    # -- snapshot ------------------------------------------------------------
    def snapshot(self) -> dict:
        """Per-site latency summary (the ``/debug`` surfaces read this),
        every pending call resolved first."""
        self.flush()
        sites = {}
        for site, h in sorted(self._hists.items()):
            if h.count:
                sites[site] = {
                    "count": h.count,
                    "mean_s": h.mean,
                    "p50_s": h.quantile(0.5),
                    "p99_s": h.quantile(0.99),
                    "flops": self.registry.value("kernel_flops", site=site),
                    "bytes": self.registry.value("kernel_bytes", site=site),
                }
        return {"every": self.every, "profiled_steps": self._step // self.every,
                "sites": sites}


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested params dict."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return int(np.prod(tree.shape)) * tree.element_size()


def attach_dispatch_hook(registry: MetricsRegistry):
    """Install the LUT-MU dispatch counter hook; returns a detach
    callable.  Counts backend selections on static metadata when a step
    program builds — one event per built program and projection, zero
    per-step cost."""
    from repro_torch.kernels import dispatch as D

    def hook(*, backend: str, input_kind: str, **_meta) -> None:
        registry.counter(
            "lutmu_dispatch_total",
            "LUT-MU programs compiled per selected backend",
            backend=backend, input_kind=input_kind).inc()

    D.set_profile_hook(hook)

    def detach() -> None:
        D.set_profile_hook(None)

    return detach

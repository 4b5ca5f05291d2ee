"""Each serving step as one captured program, the counterpart of the JAX
engines' ``jax.jit`` step functions with donated caches.

A :class:`StepProgram` holds a step function, its static int32 input
buffers and, on a CUDA device, one ``torch.cuda.CUDAGraph`` of the
function captured at those buffers.  The caches are not inputs: the
function closes over the engine's KV buffers, which it updates in place,
so they stay the same tensors for the engine's life (JAX donates them).

On the card the first call

1. fills the input buffers with the program's *idle* values — every page
   table row on the trash page, ``n_valid`` 0 — so warm-up and capture
   write no real page;
2. runs the function once eagerly on a side stream, which fills the
   kernels' cached launch plans and occupancy queries, sets their
   ``cudaFuncSetAttribute`` limits and loads the libraries, none of which
   may run inside a capture;
3. captures the function on that stream into the engine's graph pool.

Every call then stages its host inputs in one pinned int32 buffer, moves
them with one ``non_blocking`` copy and replays the graph.  Float and
uint32 inputs travel as int32 bit views (``sampling.py::stage_rows``).  A
program may also read device tensors it is given as they are, without
staging (``tensors=``): the sampler reads the decode program's logits.  A
graph holds their addresses, so each later call must pass the same
tensors: another one raises.  The outputs are
static tensors, rewritten by the next replay: the caller reads them first.
The kernel wrappers count their launches in Python, which runs at capture
and not at replay, so the counts of both runs are taken back out and each
replay adds what the capture launched (``kernels/_build.py``).  A capture
that fails raises; nothing falls back to eager.

On the CPU there are no graphs: a call copies its inputs into the buffers
and runs the function on them, returning its fresh outputs.

``builds`` counts what a JAX engine's compile cache counts: captures on the
card, first calls for an input signature on the CPU (the recorder reports
its growth as ``jit_cache_misses_total``).  The LUT-MU dispatch hook
(``kernels/dispatch.py::set_profile_hook``) fires on building calls only —
the capture, not its warm-up, and on the CPU not the calls after the first
— so it counts built programs, as JAX's counts traces.  ``cost`` (set by
the engine) gives the kernel profiler a program's flops and bytes from its
inputs' shapes without running it.

Observed: with the engine's recorder (``obs``), a call opens two host
spans on the recorder's ``programs`` lane, ``<name>.stage`` (the wait on
the last input copy, the pinned fill, the copy's enqueue) and
``<name>.launch`` (the replay), each also a ``torch.profiler`` range
while the profiler records (``obs.Span``).  On a profiled
step of the recorder's kernel profiler the call also records a pair of
CUDA events on its stream, before the input copy and after the replay,
and hands them to the profiler unresolved: no sync.  With the default
``NullRecorder`` a call pays one truthiness check.
"""
from __future__ import annotations

import ctypes
import gc
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import dispatch as D
from repro_torch.serving.obs import NULL_RECORDER, Tracer

# name → (shape, idle value) of each int32 input
InputSpec = Dict[str, Tuple[Tuple[int, ...], int]]


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> int:
    """Node count of a graph captured with ``keep_graph=True``
    (``cuGraphGetNodes`` from ``libcuda``; a ``cudaGraph_t`` is a
    ``CUgraph``)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphGetNodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    err = cuda.cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return int(n.value)


class StepProgram:
    """One serving step at fixed shapes: ``program(**arrays)`` runs
    ``fn(**inputs)`` on the arrays (host ints, each of its input's shape)
    and returns its output tensor or tuple of tensors.

    ``pool``: the engine's graph memory pool, shared by all its programs
    (they never run at once).  ``stats``: where the capture's seconds and
    the graph's node count go, under ``capture_s[name]`` and
    ``graph_nodes[name]``.  ``tensors``: names of device-tensor inputs
    passed through unstaged, the same tensors on every call on the card.
    ``cost``: ``(arrays) -> (flops, bytes)`` of one call, for the kernel
    profiler (``serving/profiler.py``).  ``obs``: the engine's recorder,
    whose spans and kernel profiler observe each call.
    """

    def __init__(self, fn: Callable, inputs: InputSpec, device: torch.device,
                 *, name: str, pool=None, stats: Optional[dict] = None,
                 tensors: Tuple[str, ...] = (),
                 cost: Optional[Callable] = None, obs=None):
        self.fn = fn
        self.name = name
        self.obs = obs if obs is not None else NULL_RECORDER
        self._spans = (f"{name}.stage", f"{name}.launch")
        self.tensors = tuple(tensors)
        self.cost = cost
        self.builds = 0
        self._signatures = set()  # input signatures seen on the CPU
        self._bound: Optional[Dict[str, torch.Tensor]] = None
        self.device = device
        self.pool = pool
        self.stats = stats if stats is not None else {}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self._launches: Optional[_build.CapturedLaunches] = None
        self._idle = {k: v for k, (_, v) in inputs.items()}
        sizes = {k: int(np.prod(shape)) for k, (shape, _) in inputs.items()}
        total = sum(sizes.values())
        on_cuda = device.type == "cuda"
        with torch.inference_mode():
            self._host = torch.empty((total,), dtype=torch.int32,
                                     pin_memory=on_cuda)
            self._dev = (torch.empty((total,), dtype=torch.int32,
                                     device=device) if on_cuda else self._host)
        host_np = self._host.numpy()
        self._host_np: Dict[str, np.ndarray] = {}
        self.inputs: Dict[str, torch.Tensor] = {}
        off = 0
        for k, (shape, _) in inputs.items():
            n = sizes[k]
            self._host_np[k] = host_np[off:off + n].reshape(shape)
            self.inputs[k] = self._dev[off:off + n].view(shape)
            off += n
        self._copied = torch.cuda.Event() if on_cuda else None

    @torch.inference_mode()
    def __call__(self, **arrays):
        tensors = {k: arrays.pop(k) for k in self.tensors if k in arrays}
        if tensors.keys() != set(self.tensors):
            raise ValueError(f"{self.name} program takes tensors "
                             f"{list(self.tensors)}, got {sorted(tensors)}")
        if self.device.type == "cuda":
            if self.graph is None:
                self._capture(tensors)
            for k, t in tensors.items():
                b = self._bound[k]
                if (t.data_ptr(), t.shape, t.stride()) != (
                        b.data_ptr(), b.shape, b.stride()):
                    raise ValueError(f"{self.name} program was captured "
                                     f"reading another {k!r} tensor")
        obs = self.obs
        if not obs:
            self._stage(arrays)
            return self._launch(tensors)
        prof = obs.profiler
        start = (prof.start_event(self.device) if prof is not None
                 else None)
        stage, launch = self._spans
        with obs.span(stage, Tracer.PROGRAM_TID):
            self._stage(arrays, start)
        with obs.span(launch, Tracer.PROGRAM_TID):
            out = self._launch(tensors)
        if start is not None:
            prof.program_call(self.name, start)
        return out

    def _launch(self, tensors: Dict[str, torch.Tensor]):
        """Replay the graph (the card), or run the function on the staged
        buffers (the CPU)."""
        if self.graph is not None:
            self.graph.replay()
            self._launches.replay()
            return self.outputs
        sig = tuple((k, tuple(t.shape), t.dtype)
                    for k, t in sorted(tensors.items()))
        if sig not in self._signatures:
            self._signatures.add(sig)
            self.builds += 1
            return self.fn(**self.inputs, **tensors)
        with D.profile_hook_paused():
            return self.fn(**self.inputs, **tensors)

    @torch.inference_mode()
    def build(self, **arrays) -> None:
        """Capture the program now if it has not been captured (on the
        card; the CPU builds at a call), so that the next call times a
        replay and not a capture.  Reads only the ``tensors`` inputs."""
        if self.device.type == "cuda" and self.graph is None:
            self._capture({k: arrays[k] for k in self.tensors})

    def _stage(self, arrays, start=None) -> None:
        """Fill the pinned buffer and enqueue its copy, recording ``start``
        (a CUDA event, where given) just before the copy."""
        if arrays.keys() != self._host_np.keys():
            raise ValueError(f"{self.name} program takes inputs "
                             f"{sorted(self._host_np)}, got {sorted(arrays)}")
        if self._copied is not None:
            self._copied.synchronize()  # the last copy has left the buffer
        for k, view in self._host_np.items():
            a = np.asarray(arrays[k])
            if a.shape != view.shape:
                raise ValueError(f"{self.name} input {k!r}: shape {a.shape} "
                                 f"!= {view.shape}")
            view[...] = a
        if self._copied is not None:
            if start is not None:
                start.record()
            self._dev.copy_(self._host, non_blocking=True)
            self._copied.record()

    def _capture(self, tensors: Dict[str, torch.Tensor]) -> None:
        t0 = time.perf_counter()
        for k, t in self.inputs.items():
            t.fill_(self._idle[k])
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        out = []

        def warm_up():
            with torch.cuda.stream(stream), D.profile_hook_paused():
                self.fn(**self.inputs, **tensors)

        # on a mesh the NCCL collectives are captured too; the process
        # group's watchdog thread keeps querying its events meanwhile,
        # which only a thread-local capture allows
        mode = ("thread_local" if torch.distributed.is_available()
                and torch.distributed.is_initialized() else "global")

        def capture():
            # the outer context restores the caller's stream even when a
            # failed capture's ``capture_end`` raises before the graph
            # context leaves its stream
            with torch.cuda.stream(stream):
                with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                      capture_error_mode=mode):
                    out.append(self.fn(**self.inputs, **tensors))

        # no cyclic garbage collection inside a capture: a dead engine's
        # graph freed there (``cudaGraphExecDestroy``) invalidates it, so
        # dead cycles go first and the collector waits until the end
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            self._launches = _build.CapturedLaunches(warm_up, capture)
        except RuntimeError as e:
            # e.g. a host read or a data-dependent shape inside the step: the
            # plain ``ref`` LUT-MU contraction (``nonzero``) cannot be
            # captured, so an engine on the card serves auto, fused or
            # unfused
            raise RuntimeError(f"the {self.name} step program could not be "
                               f"captured: {e}") from e
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph.instantiate()
        self.graph, self.outputs, self._bound = graph, out[0], tensors
        self.builds += 1
        self.stats.setdefault("capture_s", {})[self.name] = (
            time.perf_counter() - t0)
        self.stats.setdefault("graph_nodes", {})[self.name] = graph_nodes(graph)

"""Continuous-batching serving over a paged KV cache (PyTorch).

The port of ``repro.serving.engine.ServeEngine``: a host-side scheduler
(``scheduler.py``: FCFS + priority admission, page-fault eviction with host
swap, cancellation, per-request budgets) over a paged KV cache
(``kv_cache.py``) with **chunked prefill** — long prompts advance one
fixed-width chunk per step and interleave with the batched decode.  Each
step runs at most one prefill chunk and one decode of ``max_batch`` rows
through ``models/model.py``; the model writes the K/V pages in place.
Each of the two is one :class:`~repro_torch.serving.programs.StepProgram`
at the engine's fixed shapes (``_decode``, ``_prefill``): on the card one
CUDA-graph replay per step, as the JAX engine runs one jitted program.
Requests sample with temperature / top-k / top-p from per-request seeded
streams equal to JAX's (``sampling.py``): a step whose rows are all greedy
takes the argmax of the logits; otherwise the sampler runs on the device
as one more small program (``_sample_decode``, ``_sample_prefill``) that
reads the step program's logits in place.  ``cfg.amm.kv_int8`` serves
from an int8-quantised KV cache.  :meth:`ServeEngine._from_artifact` serves
a compiled ``amm_lm`` artifact (``compiler/artifact.py``) spliced into the
dense params.  ``speculative.py`` subclasses the engine
through its per-step hooks: ``_swap_out``/``_swap_in``, ``_clone_pages``
and ``_run_decode``, and its own programs.

:class:`FixedSlotEngine` is the port of the JAX fixed-slot engine: one
``(L, slots, max_len, …)`` cache, whole-prompt eager prefill on admission
and one batched decode per step, the decode a ``StepProgram`` over the
cache captured once.  It is the paged engine's differential oracle (their
streams are equal, dense and int-LUT) and the serving path of the families
without a paged layout: SSM, hybrid, enc-dec.  ``load_engine`` (and the
deprecated :func:`make_engine`) pick the engine by family.

Observability (``obs.py``): ``recorder=`` threads one recorder through the
scheduler, the cache and its allocator, and the engine's own hook sites,
the JAX engine's: request lifecycle, prefill and decode spans, tokens, pool
gauges and the step programs' builds (as ``jit_cache_misses_total``).  A
kernel profiler on the recorder (``profiler.py``) times the program calls
of every ``every``-th step by CUDA events, with no sync; a quality probe
(``quality.py``) is bound to the params the engine serves.  Every hook
runs on the host around a program call, never inside a captured graph;
with the default ``NullRecorder`` each site costs one truthiness check.
While ``torch.profiler`` records, the spans the engine opens around its
step programs (``decode``, ``prefill[i]``, ``spec-round``) are also
profiler ranges of the same names (``obs.Span``).
"""
from __future__ import annotations

import dataclasses
import itertools
import re
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.annotate import NO_RANGE
from repro_torch.compiler.artifact import ArtifactError, load_artifact
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (ParallelContext, flatten,
                                              local_shape, mesh_shape,
                                              shard_params, unflatten)
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.serving import sampling as S
from repro_torch.serving import scheduler as SCH
from repro_torch.serving.handle import RequestHandle, _step_engine_async
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.obs import NULL_RECORDER, log
from repro_torch.serving.profiler import forward_cost, tree_bytes
from repro_torch.serving.programs import StepProgram
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request, Scheduler


def _splice_artifact(art, params: dict, cfg: ModelConfig, device="cuda",
                     mesh=None):
    """Validate a loaded ``amm_lm`` artifact against ``cfg``, splice its
    LUT-MU tables into the dense params tree on ``device``, and enable the
    AMM path with the artifact's recorded settings (the speculative engine
    calls it once per bundle half).  A serving ``mesh`` other than the one
    the manifest records is reported, not rejected: the rules place the
    tables on any mesh.  On a mesh the tables are spliced on the host, and
    the engine moves only this rank's shards to ``device``."""
    if art.kind != "amm_lm":
        raise ArtifactError(
            f"ServeEngine needs an amm_lm artifact, got {art.kind!r}")
    if art.manifest.get("arch") != cfg.name:
        raise ArtifactError(
            f"artifact was compiled for arch {art.manifest.get('arch')!r}"
            f", engine config is {cfg.name!r}")
    # the arch name alone doesn't pin geometry (reduced configs share it)
    if art.manifest.get("num_layers") != cfg.num_layers:
        raise ArtifactError(
            f"artifact has {art.manifest.get('num_layers')} layers, "
            f"config expects {cfg.num_layers} (reduced vs full?)")
    # int4 artifacts pack two LUT columns per stored byte; the manifest
    # records the true column count
    d_out = art.manifest.get("int4_cols", {}).get(
        "layer0/lut_down", art.tensors["layer0/lut_down"].shape[-1])
    if d_out != cfg.d_model:
        raise ArtifactError(
            f"artifact d_model {d_out} != config d_model {cfg.d_model}")
    cfg = dataclasses.replace(
        cfg, amm=dataclasses.replace(cfg.amm, enabled=True,
                                     **art.manifest["amm"]))
    want = art.manifest.get("mesh")
    if want and mesh is not None:
        have = mesh_shape(mesh)
        if {k: int(v) for k, v in want.items()} != have:
            log("serve", f"note: artifact was compiled for mesh {want}, "
                f"serving on {have}")
    return art.splice_lm_params(
        params, device=device if mesh is None else "cpu"), cfg


def _artifact_params_cfg(artifact_path, params: dict, cfg: ModelConfig,
                         device="cuda", mesh=None):
    """Load an ``amm_lm`` artifact from disk and splice it (see
    :func:`_splice_artifact`)."""
    return _splice_artifact(load_artifact(artifact_path), params, cfg, device,
                            mesh)


def _parallel(params: dict, cfg: ModelConfig, mesh, device: torch.device,
              params_shape=None):
    """``(params, par)`` an engine serves: off a mesh the params as given
    and no context; on one this rank's shards, on ``device``, and its
    parallel context.  The whole tree is best given on the host: it is cut
    where it lies, and only the shards go to the card.  With
    ``params_shape`` (the whole tree's shapes, e.g. on ``meta``) ``params``
    already holds this rank's shards (``init_params(..., shard=)``), moved
    to ``device`` as they are."""
    if mesh is None:
        return params, None
    if mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot serve on "
                         f"{device}")
    if params_shape is not None:
        par = ParallelContext(cfg, mesh, params_shape)
        return unflatten({p: t.to(device) for p, t in
                          flatten(params).items()}), par
    par = ParallelContext(cfg, mesh, params)
    return shard_params(params, cfg, mesh, device=device), par


def _bind_quality(obs, params: dict, cfg: ModelConfig) -> None:
    """Point the recorder's quality probe (if one is attached) at the
    params the engine serves.  ``bind`` is first-wins, so the target half
    of a speculative engine is the one probed."""
    quality = getattr(obs, "quality", None)
    if quality is not None:
        quality.bind(params, cfg)


def _profiled_call(obs, site: str, program: StepProgram, **arrays):
    """Route one program call through the kernel profiler on profiled
    steps.  Off (no recorder, no profiler, or an unprofiled step) it costs
    one truthiness check and one attribute read — no wrapper, no sync."""
    prof = getattr(obs, "profiler", None) if obs else None
    if prof is not None and prof.active:
        return prof.timed(site, program, **arrays)
    return program(**arrays)


class ServeEngine:
    """Continuous-batching serving over a paged KV cache."""

    _prefill_site = "serve.prefill"  # the profiler's site of ``_prefill``

    def __init__(self, params: dict, cfg: ModelConfig, *,
                 max_batch: int = 4, max_len: int = 256, page_size: int = 16,
                 prefill_chunk: int = 32, num_pages: Optional[int] = None,
                 prefix_cache: bool = True, compute_dtype=torch.float32,
                 device="cuda", verify_backend: str = "auto", recorder=None,
                 mesh=None, params_shape=None):
        if not MD.supports_paged(cfg):
            raise ValueError(
                f"family {cfg.family!r} has no paged decode path — serve it "
                "with FixedSlotEngine")
        self.cfg = cfg
        # speculative verify-window implementation, resolved once (env
        # override included); the plain engine never verifies but keeps it
        # for SpeculativeEngine
        self.verify_backend = MD.resolve_verify_backend(verify_backend)
        # observability: one recorder for the scheduler, the cache, its
        # allocator and the hook sites below (obs.py)
        self.obs = recorder if recorder is not None else NULL_RECORDER
        self.device = resolve_device(device)
        # on a ``data × model`` mesh (``launch/mesh.py``) the engine holds
        # this rank's shards, and every rank runs the same host schedule
        self.mesh = mesh
        self.params, self.par = _parallel(params, cfg, mesh, self.device,
                                          params_shape)
        self.max_batch = int(max_batch)
        self.max_len = max_len
        self.page_size = ps = int(page_size)
        self.prefill_chunk = int(prefill_chunk)
        self.max_pages_per_seq = mp = -(-max_len // ps)
        if num_pages is None:
            # full provisioning: no eviction unless the caller shrinks it
            num_pages = self.max_batch * mp
        self.cd = compute_dtype
        self._uid = itertools.count()
        # the int8-quantised KV cache is a model feature (cfg.amm.kv_int8);
        # decode, prefill and verify key their quantise-on-write off the
        # page type
        self.kv_dtype = (torch.int8 if cfg.amm.enabled and cfg.amm.kv_int8
                         else compute_dtype)
        # on a mesh the pool is padded to the data degree and a rank holds
        # its shard of the pages (JAX's paged_cache_shardings), its kv
        # heads those of its attention shard
        par = self.par
        self.kv = PagedKVCache(MD._acfg(cfg, par), num_pages=num_pages,
                               page_size=ps, dtype=self.kv_dtype,
                               pad_to=1 if par is None else par.dp,
                               device=self.device, recorder=recorder, par=par)
        self.sched = Scheduler(
            max_batch=self.max_batch, allocator=self.kv.allocator,
            page_size=ps, max_pages_per_seq=mp,
            prefill_chunk=self.prefill_chunk, max_len=max_len,
            prefix_cache=prefix_cache, recorder=recorder)
        self._driver = None  # a server driver that owns the loop, if any
        # model calls made, for callers that check per-call kernel counts;
        # the programs add their capture seconds and graph node counts
        self.stats = {"prefill_calls": 0, "decode_calls": 0}
        # the step programs (JAX ``_decode``/``_prefill``): one graph pool
        # for all of an engine's programs, which never run at once
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        params, kv, cd = self.params, self.kv.buffers, compute_dtype

        def decode(token, pos, table):
            return MD.paged_decode_step(params, token, pos, table, kv, cfg,
                                        compute_dtype=cd, par=par)

        def prefill(tokens, start, n_valid, row):
            return MD.paged_prefill_chunk(params, tokens, start, n_valid, row,
                                          kv, cfg, compute_dtype=cd, par=par)

        self._kv_itemsize = kv["k"].element_size()
        self._param_bytes = tree_bytes(params)
        self._decode = self._program(decode, "decode", self._decode_inputs(),
                                     cost=self._decode_cost)
        self._prefill = self._program(prefill, "prefill",
                                      self._prefill_inputs(),
                                      cost=self._prefill_cost)
        # the device sampler of a decode batch and of a prefill's first token
        self._sample_decode = self._sampler("sample_decode", self.max_batch)
        self._sample_prefill = self._sampler("sample_prefill", 1)
        if self.obs:
            # the JAX engine's dispatch sites; its one jitted sampler is
            # the port's two sampler programs
            for site, prog in (("serve.decode", self._decode),
                               ("serve.prefill", self._prefill),
                               ("sampling.sample_tokens", self._sample_decode),
                               ("sampling.sample_tokens",
                                self._sample_prefill)):
                self.obs.register_jit_site(site, prog)
            _bind_quality(self.obs, self.params, self.cfg)

    @classmethod
    def _from_artifact(cls, artifact_path, params: dict, cfg: ModelConfig,
                       **kwargs) -> "ServeEngine":
        """Serve a compiled ``amm_lm`` artifact: splice its LUT-MU tables
        into ``params`` (replacing the dense MLPs) and enable the AMM path
        with the artifact's recorded settings.  ``params`` is the dense
        params tree the artifact was compiled against; the arch name, depth
        and width must match."""
        params, cfg = _artifact_params_cfg(artifact_path, params, cfg,
                                           kwargs.get("device", "cuda"),
                                           kwargs.get("mesh"))
        return cls(params, cfg, **kwargs)

    # -- API -------------------------------------------------------------
    def submit(self, prompt: List[int],
               sampling: Optional[SamplingParams] = None, *,
               max_new_tokens: int = 16, eos_id: Optional[int] = None,
               priority: int = 0) -> RequestHandle:
        """Queue a request; returns a :class:`RequestHandle`.  ``sampling``
        defaults to greedy."""
        sampling = sampling if sampling is not None else SamplingParams()
        req = Request(uid=next(self._uid), prompt=list(prompt),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      priority=priority, sampling=sampling)
        self.sched.submit(req)
        return RequestHandle(self, req)

    def cancel(self, uid: int) -> bool:
        return self.sched.cancel(uid)

    @property
    def has_work(self) -> bool:
        return bool(self.sched.live())

    async def _advance_async(self) -> None:
        await _step_engine_async(self)

    def step(self) -> List[Request]:
        """One engine iteration: execute the scheduler's plan — swap-outs,
        swap-ins, copy-on-write clones, at most one prefill chunk, one
        batched decode — and retire finished requests."""
        prof = None
        if self.obs:
            prof = self.obs.profiler
            if prof is not None:
                prof.tick()
        plan = self.sched.schedule()
        for req, old_pages in plan.swap_out:
            # the allocator already released these pages; copy them before
            # anything writes (the first writes happen below)
            self._swap_out(req, old_pages)
        for req in plan.swap_in:
            self._swap_in(req)
        for clone in plan.cow:
            if clone.req.cow is None:
                continue  # dropped: its request was evicted in this plan
            self._clone_pages(clone.src, clone.dst)
            self.sched.cow_executed(clone)
        finished: List[Request] = []
        if plan.prefill is not None:
            self._run_prefill_chunk(plan.prefill, finished)
        if plan.decode:
            self._run_decode(plan.decode, finished)
        if self.obs:
            self.obs.sample_pool(self.kv.allocator)
            self.obs.poll_jit()
            if prof is not None and prof.active:
                prof.end_step(self.has_work)
        return finished

    def run_until_drained(self, max_steps: int = 10000) -> List[Request]:
        """Step until idle; raise rather than return a partial result when
        the step budget runs out with requests still live."""
        done: List[Request] = []
        for _ in range(max_steps):
            done.extend(self.step())
            if not self.has_work:
                return done
        raise RuntimeError(
            f"run_until_drained: {max_steps} steps exhausted with "
            f"{len(self.sched.live())} request(s) still live ({len(done)} "
            "finished) — raise max_steps for longer workloads, or "
            "investigate a stuck schedule")

    # -- internals ---------------------------------------------------------
    def _program(self, fn, name: str, inputs, tensors=(),
                 cost=None) -> StepProgram:
        return StepProgram(fn, inputs, self.device, name=name,
                           pool=self._pool, stats=self.stats, tensors=tensors,
                           cost=cost, obs=self.obs)

    def _forward_cost(self, cfg: ModelConfig, rows: int, tokens: int,
                      head_tokens: int, param_bytes: int):
        """``(flops, bytes)`` of one forward at the engine's cache view
        (``profiler.py::forward_cost``)."""
        return forward_cost(cfg, rows=rows, tokens=tokens,
                            ctx=self.max_pages_per_seq * self.page_size,
                            head_tokens=head_tokens,
                            kv_itemsize=self._kv_itemsize,
                            param_bytes=param_bytes)

    def _decode_cost(self, arrays):
        return self._forward_cost(self.cfg, len(arrays["token"]), 1, 1,
                                  self._param_bytes)

    def _prefill_cost(self, arrays):
        return self._forward_cost(self.cfg, 1, arrays["tokens"].shape[1], 1,
                                  self._param_bytes)

    def _sampler(self, name: str, batch: int) -> StepProgram:
        """The sampler of ``batch`` rows as a program reading the logits
        ``(batch, V)`` it is given in place, its per-row parameters staged
        as int32 bit views."""
        def sample(logits, seed, t, temperature, top_k, top_p):
            return S.sample_tokens(logits, *S.from_staged(
                seed, t, temperature, top_k, top_p))

        return self._program(sample, name, S.staged_inputs(batch),
                             tensors=("logits",))

    def _sample(self, logits: torch.Tensor, rows_reqs,
                program: StepProgram) -> np.ndarray:
        """``logits (batch, V)`` + ``(row, request)`` pairs → ``(batch,)``
        int32 tokens on the host; rows not listed are greedy and discarded.
        An all-greedy batch takes the argmax (the sampler's T = 0 path gives
        the same tokens), any other the sampler ``program``."""
        if S.all_greedy(rows_reqs):
            return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        staged = S.stage_rows(rows_reqs, logits.shape[0])
        return program(logits=logits, **staged).cpu().numpy()

    def _decode_inputs(self, **extra):
        """The decode-shaped inputs ``(shape, idle value)``: rows without a
        request on the trash page (``extra`` adds inputs)."""
        mb, mp = self.max_batch, self.max_pages_per_seq
        return {"token": ((mb, 1), 0), "pos": ((mb,), 0), **extra,
                "table": ((mb, mp), self.kv.trash)}

    def _prefill_inputs(self):
        return {"tokens": ((1, self.prefill_chunk), 0), "start": ((), 0),
                "n_valid": ((), 0),
                "row": ((self.max_pages_per_seq,), self.kv.trash)}

    def _swap_out(self, req: Request, old_pages: List[int]) -> None:
        """Copy an evicted request's pages to the host (the speculative
        engine copies its draft cache too)."""
        req.host_kv = self.kv.gather_host(old_pages)

    def _swap_in(self, req: Request) -> None:
        """Write a resumed request's host copy into its new pages."""
        self.kv.scatter_host(req.host_kv, req.pages)
        req.host_kv = None

    def _clone_pages(self, src: int, dst: int) -> None:
        """Device copy backing one copy-on-write clone (the speculative
        engine clones its draft cache too)."""
        self.kv.clone_page(src, dst)

    def _run_prefill_chunk(self, chunk: SCH.PrefillChunk,
                           finished: List[Request]) -> None:
        req = chunk.req
        toks = np.zeros((1, self.prefill_chunk), np.int32)
        toks[0, : chunk.n_valid] = req.prompt[chunk.start:
                                              chunk.start + chunk.n_valid]
        page_row = self.kv.page_row(req.pages, self.max_pages_per_seq)
        obs = self.obs
        index = chunk.start // self.prefill_chunk
        last = req.pf_done + chunk.n_valid == len(req.prompt)
        # the last chunk's sampled token comes to the host; for any other
        # chunk the span measures staging and the replay's launch
        with obs.span(f"prefill[{index}]") if obs else NO_RANGE as sp:
            # (1, 1, V) target logits; the speculative engine's program
            # also prefills its draft cache
            logits = _profiled_call(obs, self._prefill_site, self._prefill,
                                    tokens=toks, start=chunk.start,
                                    n_valid=chunk.n_valid, row=page_row)
            if last:
                req.generated.append(int(self._sample(
                    logits[0, -1:], [(0, req)], self._sample_prefill)[0]))
        self.stats["prefill_calls"] += 1
        req.pf_done += chunk.n_valid
        if obs:
            obs.on_prefill(req, index, chunk.n_valid, sp.t0, sp.t1)
        if last:
            if obs:
                obs.on_tokens(req, 1, sp.t1, source="prefill")
            # prefill_finished first — it indexes the prompt pages for
            # prefix reuse, which a budget-limited request still provides
            self.sched.prefill_finished(req)
            if req.budget_reached(self.max_len):
                self.sched.retire(req)
                finished.append(req)

    def _run_decode(self, decode, finished: List[Request]) -> None:
        token = np.zeros((self.max_batch, 1), np.int32)
        pos = np.zeros((self.max_batch,), np.int32)
        table = np.full((self.max_batch, self.max_pages_per_seq),
                        self.kv.trash, np.int32)
        for row, req in decode:
            token[row, 0] = req.generated[-1]
            pos[row] = req.next_pos
            table[row, : len(req.pages)] = req.pages
        obs = self.obs
        with obs.span("decode") if obs else NO_RANGE as sp:
            logits = _profiled_call(obs, "serve.decode", self._decode,
                                    token=token, pos=pos, table=table)
            # the sampled tokens come to the host, so the span covers the
            # step's device time without a sync of the recorder's own
            nxt = self._sample(logits[:, 0], decode, self._sample_decode)
        self.stats["decode_calls"] += 1
        if obs:
            obs.on_decode(decode, sp.t0, sp.t1, name=sp.name)
        for row, req in decode:
            req.generated.append(int(nxt[row]))
            if obs:
                obs.on_tokens(req, 1, sp.t1)
            if req.budget_reached(self.max_len):
                self.sched.retire(req)
                finished.append(req)


_KV_LEAF = re.compile(r"(^|/)(k|v|cross_k|cross_v)$")


def _splice_slot(full: dict, one: dict, slot: int, slots: int,
                 par=None) -> None:
    """Copy a one-row prefill cache into row ``slot`` of the engine's
    cache, in place (the captured decode program reads these buffers):
    every leaf with a slot axis (``one.dim() >= 2 and full.shape[1] ==
    slots``, the JAX engine's rule), cast to the leaf's type.

    On a mesh (``par``) ``one`` is in the layout the model computes on
    (whole sequence; under Mamba TP the rank's Mamba heads and channels,
    as ``full`` holds them) and ``full`` placed by ``par.place_cache``: a
    leaf whose slots split over ``data`` is written only by the data rank
    that holds ``slot``, at its local row, and a K/V leaf whose sequence
    is cut takes this rank's slice of the prompt's."""
    ones = flatten(one)
    for path, f in flatten(full).items():
        o = ones[path]
        if par is not None:
            if _KV_LEAF.search(path):
                o = par.seq_slice(o, path)
            if par.cache_specs[path][1:2] == ("data",) and par.dp > 1:
                n = slots // par.dp
                if slot // n == par.dp_rank:
                    f[:, slot % n].copy_(o[:, 0].to(f.dtype))
                continue
        if o.dim() >= 2 and f.shape[1] == slots:
            f[:, slot].copy_(o[:, 0].to(f.dtype))


class FixedSlotEngine:
    """Continuous batching over fixed decode slots: one ``(L, slots,
    max_len, …)`` cache and whole-prompt eager prefill on admission.  The
    paged engine's differential-test oracle, and the serving path for the
    SSM, hybrid and enc-dec families.

    Admission is FIFO.  Each step admits into free slots (prefill, the
    request's first token, the one-row cache copied into its slot), then
    runs one decode of every slot at its own position — the ``_decode``
    program, whose inputs are the tokens ``(slots, 1)`` and positions
    ``(slots,)`` and which updates the cache in place — and retires
    requests that reach their budget, eos or ``max_len - 1``.  Idle slots
    decode too, into rows nobody reads.  On the card the program is
    captured when the engine is made, before any slot holds a request: its
    eager warm-up writes only idle rows.
    """

    def __init__(self, params: dict, cfg: ModelConfig, *, slots: int = 4,
                 max_len: int = 256, compute_dtype=torch.float32,
                 device="cuda", recorder=None, mesh=None, params_shape=None):
        self.cfg = cfg
        self.slots = int(slots)
        self.max_len = max_len
        self.cd = compute_dtype
        self.device = resolve_device(device)
        self.mesh = mesh
        self.params, self.par = _parallel(params, cfg, mesh, self.device,
                                          params_shape)
        params, par = self.params, self.par
        # the same zero-overhead-off observability as ServeEngine (no
        # scheduler here, so the lifecycle hooks fire from the engine)
        self.obs = recorder if recorder is not None else NULL_RECORDER
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}  # slot -> request
        self.pos = np.zeros(self.slots, dtype=np.int64)  # next position
        self._uid = itertools.count()
        self._driver = None  # a server driver that owns the loop, if any
        self.stats = {"prefill_calls": 0, "decode_calls": 0}
        if par is None:
            self.cache = MD.init_cache(cfg, self.slots, max_len,
                                       compute_dtype, self.device)
        else:
            # this rank's part, placed as JAX's cache_shardings places it
            # (the sequence cut where the rule cuts it; the Mamba state's
            # heads and conv channels over model under Mamba TP, else by
            # its slots only)
            meta = MD.init_cache(cfg, self.slots, max_len, compute_dtype,
                                 "meta")
            specs = par.place_cache(meta, self.slots)
            self.cache = unflatten({
                p: torch.zeros(local_shape(t.shape, specs[p], mesh),
                               dtype=t.dtype, device=self.device)
                for p, t in flatten(meta).items()})
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        cache, cd = self.cache, compute_dtype

        def decode(token, pos):
            # each slot decodes at its own position, so staggered
            # admissions give the streams of sequential decoding
            return MD.decode_step(params, token, pos, cache, cfg,
                                  compute_dtype=cd, par=par)

        self._decode = self._program(
            decode, "fixed_decode",
            {"token": ((self.slots, 1), 0), "pos": ((self.slots,), 0)})
        self._decode.build()  # now, while every slot is idle
        self._sample_decode = self._sampler("sample_decode", self.slots)
        self._sample_prefill = self._sampler("sample_prefill", 1)
        # the sampler reads a prefill's last logits from one static buffer
        self._prefill_logits = torch.zeros((1, cfg.vocab_size),
                                           dtype=torch.float32,
                                           device=self.device)
        if self.obs:
            for site, prog in (("fixed.decode", self._decode),
                               ("sampling.sample_tokens", self._sample_decode),
                               ("sampling.sample_tokens",
                                self._sample_prefill)):
                self.obs.register_jit_site(site, prog)
            _bind_quality(self.obs, self.params, self.cfg)

    @classmethod
    def _from_artifact(cls, artifact_path, params: dict, cfg: ModelConfig,
                       **kwargs) -> "FixedSlotEngine":
        """Serve a compiled ``amm_lm`` artifact through fixed slots (see
        :meth:`ServeEngine._from_artifact`)."""
        params, cfg = _artifact_params_cfg(artifact_path, params, cfg,
                                           kwargs.get("device", "cuda"),
                                           kwargs.get("mesh"))
        return cls(params, cfg, **kwargs)

    # -- API -------------------------------------------------------------
    def submit(self, prompt: List[int],
               sampling: Optional[SamplingParams] = None, *,
               max_new_tokens: int = 16, eos_id: Optional[int] = None,
               priority: int = 0) -> RequestHandle:
        """Queue a request; returns a :class:`RequestHandle` (the contract
        of :meth:`ServeEngine.submit`; admission ignores ``priority``)."""
        del priority  # fixed-slot admission is strictly FIFO
        if len(prompt) >= self.max_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens ≥ max_len {self.max_len}")
        req = Request(uid=next(self._uid), prompt=list(prompt),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      sampling=sampling if sampling is not None
                      else SamplingParams())
        self.queue.append(req)
        if self.obs:
            self.obs.on_submit(req)
        return RequestHandle(self, req)

    def cancel(self, uid: int) -> bool:
        """Drop a queued or active request.  False when the uid is unknown
        or already finished."""
        for req in list(self.queue):
            if req.uid == uid:
                self.queue.remove(req)
                return self._mark_cancelled(req)
        for slot, req in list(self.active.items()):
            if req.uid == uid:
                del self.active[slot]
                return self._mark_cancelled(req)
        return False

    def _mark_cancelled(self, req: Request) -> bool:
        req.state = SCH.DONE
        req.cancelled = True
        req.done = True
        if self.obs:
            self.obs.on_cancel(req)
        return True

    async def _advance_async(self) -> None:
        await _step_engine_async(self)

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.active)

    def step(self) -> List[Request]:
        """One engine iteration: admit, one batched decode, retire."""
        obs = self.obs
        prof = None
        if obs:
            prof = obs.profiler
            if prof is not None:
                prof.tick()
        finished = self._admit()
        if not self.active:
            if obs:
                obs.poll_jit()
                if prof is not None and prof.active:
                    prof.end_step(self.has_work)
            return finished
        token = np.zeros((self.slots, 1), dtype=np.int32)
        for slot, req in self.active.items():
            token[slot, 0] = req.generated[-1]
        rows = list(self.active.items())
        with obs.span("decode") if obs else NO_RANGE as sp:
            logits = _profiled_call(obs, "fixed.decode", self._decode,
                                    token=token,
                                    pos=self.pos.astype(np.int32))
            nxt = self._sample(logits[:, 0], rows, self._sample_decode)
        self.stats["decode_calls"] += 1
        if obs:
            obs.on_decode(rows, sp.t0, sp.t1, name=sp.name)
        for slot, req in rows:
            tok = int(nxt[slot])
            req.generated.append(tok)
            self.pos[slot] += 1
            if obs:
                obs.on_tokens(req, 1, sp.t1)
            # a slot retires at max_len - 1, so every position an idle
            # slot decodes at stays inside the cache
            if (len(req.generated) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id)
                    or self.pos[slot] >= self.max_len - 1):
                self._retire(req, finished)
                del self.active[slot]
        if obs:
            obs.poll_jit()
            if prof is not None and prof.active:
                prof.end_step(self.has_work)
        return finished

    def run_until_drained(self, max_steps: int = 10000) -> List[Request]:
        """Step until idle; raise rather than return a partial result when
        the step budget runs out with requests still live."""
        done: List[Request] = []
        for _ in range(max_steps):
            done.extend(self.step())
            if not self.has_work:
                return done
        raise RuntimeError(
            f"run_until_drained: {max_steps} steps exhausted with "
            f"{len(self.queue) + len(self.active)} request(s) still live "
            f"({len(done)} finished) — raise max_steps for longer "
            "workloads, or investigate a stuck schedule")

    # -- internals ---------------------------------------------------------
    _program = ServeEngine._program
    _sampler = ServeEngine._sampler
    _sample = ServeEngine._sample

    def _retire(self, req: Request, finished: List[Request]) -> None:
        req.done = True
        req.state = SCH.DONE
        finished.append(req)
        if self.obs:
            self.obs.on_finish(req)

    def _admit(self) -> List[Request]:
        """Fill free slots: each admitted prompt is prefilled alone and its
        one-row cache copied into its slot."""
        finished: List[Request] = []
        free = [s for s in range(self.slots) if s not in self.active]
        obs = self.obs
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.popleft()
            req.state = SCH.RUNNING  # for RequestHandle.status
            if obs:
                obs.on_admit(req)
            with obs.span("prefill[0]") if obs else NO_RANGE as sp:
                tokens = torch.tensor([req.prompt], dtype=torch.int32,
                                      device=self.device)
                logits, one = MD.prefill(self.params, tokens, self.cfg,
                                         self.max_len, compute_dtype=self.cd,
                                         par=self.par)
                with torch.inference_mode():
                    _splice_slot(self.cache, one, slot, self.slots, self.par)
                    self._prefill_logits.copy_(logits[0, -1:])
                del one
                req.generated.append(int(self._sample(
                    self._prefill_logits, [(0, req)],
                    self._sample_prefill)[0]))
            self.stats["prefill_calls"] += 1
            if obs:
                obs.on_prefill(req, 0, len(req.prompt), sp.t0, sp.t1)
                obs.on_tokens(req, 1, sp.t1, source="prefill")
            if req.budget_reached(self.max_len):
                self._retire(req, finished)
                free.insert(0, slot)
                continue
            self.active[slot] = req
            self.pos[slot] = len(req.prompt)
        return finished


def _family_engine(params: dict, cfg: ModelConfig, **kwargs):
    """The paged engine when the family has a paged KV layout, else fixed
    slots (``max_batch`` becomes ``slots``; the paged-only knobs go)."""
    if MD.supports_paged(cfg):
        return ServeEngine(params, cfg, **kwargs)
    return FixedSlotEngine(params, cfg, **_fixed_kwargs(kwargs))


def _fixed_kwargs(kwargs: dict) -> dict:
    """A paged engine's keywords for :class:`FixedSlotEngine`: ``max_batch``
    becomes ``slots``, the paged-only knobs are dropped (in place)."""
    slots = kwargs.pop("max_batch", None)
    if slots is not None:
        kwargs.setdefault("slots", slots)
    for k in ("page_size", "prefill_chunk", "num_pages", "prefix_cache",
              "verify_backend"):
        kwargs.pop(k, None)
    return kwargs


def make_engine(params: dict, cfg: ModelConfig, **kwargs):
    """Deprecated: use :func:`repro_torch.serving.load_engine` (``source=
    None`` gives the same family dispatch)."""
    warnings.warn(
        "make_engine is deprecated; use repro_torch.serving.load_engine("
        "None, params, cfg, ...)", DeprecationWarning, stacklevel=2)
    return _family_engine(params, cfg, **kwargs)

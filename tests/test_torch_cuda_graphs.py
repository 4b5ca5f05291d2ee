"""The serving engines' captured step programs on the card, against the
eager model functions.

These tests need a card: they carry the ``cuda`` marker and skip without
one.  The module imports no JAX, so it runs on the card as
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_graphs.py``.

A 4-layer model (``qwen3-14b --reduced``, bf16, random int8 LUTs: the
``fused_lutmu`` kernel on every projection, the verify-window kernel on the
``fused`` round) is served with a pool small enough to evict and swap in,
and prompts that share a prefix, so copy-on-write clones run between
replays.  Every program call is checked as it happens: its outputs and the
KV pages it wrote must be bit-equal to the same model function called
eagerly on a copy of the caches taken just before, and the launch counters
must move by what the eager call launched.  Left out of the comparison is
what reads or writes the trash page, which padding rows and masked window
slots write in no fixed order: the trash page itself, the logits of batch
rows without a request, and the round's window slots past a row's
``n_valid`` (past ``accepted + 1`` for the sampled round's ``emit``).
Nothing reads those.  Sampled requests run the same way through the
sampled round and the sampler programs, each replay bit-equal to
``sampled_round`` or ``sample_tokens`` called eagerly on the same inputs.
With a recorder and a kernel profiler attached, the replays stay bit-equal
to their eager twins, every program builds once, and no step synchronises
the device, profiled or not: a profiled step's program calls are timed by
CUDA events resolved later, one ``kernels``-lane span each.  The
fixed-slot engine's decode program is checked the same way on a dense
(LUT-MU), an SSM, a hybrid (LUT-MU in its dense layers) and an MoE stack:
every slot's logits and the whole cache, which has no trash page.  Last,
two sharded train steps on a 1×1 NCCL mesh equal two single-device steps
bit for bit (no graph: the train step runs eagerly).
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import fused_lutmu as FL
from repro_torch.kernels import fused_verify as FV
from repro_torch.models import model as MD
from repro_torch.serving import (FixedSlotEngine, KernelProfiler, Recorder,
                                 SamplingParams, ServeEngine,
                                 SpeculativeEngine, validate_chrome_trace,
                                 validate_prometheus)
from repro_torch.serving import sampling as S
from repro_torch.serving.obs import Tracer
from repro_torch.serving.programs import StepProgram
from repro_torch.serving.speculative import (greedy_round, prefill_pair,
                                             sampled_round)

CD = torch.bfloat16
SPEC_K = 3
STEM = [5, 1, 4, 1, 5, 9, 2, 6, 5, 3, 8, 9, 7, 9, 3, 2, 3, 8]
PROMPTS = [STEM + [7, 7, 7], STEM + [7, 7, 7], STEM + [8, 8],
           STEM[:6] + [9, 9, 9, 9], [2, 7, 1, 8, 2, 8], list(range(1, 30))]
KNOBS = dict(max_batch=3, max_len=96, page_size=4, prefill_chunk=8,
             num_pages=12, compute_dtype=CD, device="cuda")


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs and kernels have no CPU mode")
    cfg = get_config("qwen3-14b", reduced=True)
    cfg = dataclasses.replace(cfg, max_seq_len=128, amm=dataclasses.replace(
        cfg.amm, enabled=True, backend="auto"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = MD.init_params(cfg, gen, CD, serving=True)
    other = MD.init_params(cfg, gen, CD, serving=True)
    # a draft with other LUT tables on the same backbone: rounds reject
    draft = dict(params, layers=dict(params["layers"],
                                     amm_mlp=other["layers"]["amm_mlp"]))
    return cfg, params, draft


def _dev(a):
    return torch.from_numpy(np.asarray(a, np.int32)).cuda()


def _live_rows(arrays, trash):
    """The decode-batch rows that hold a request (the others read only the
    trash page)."""
    return np.flatnonzero(arrays["table"][:, 0] != trash)


def keep_decode(trash):
    return lambda arrays, outs: [outs[0][_live_rows(arrays, trash)]]


def keep_round(arrays, outs):
    """``accepted`` of the rows in the round, and each one's ``target``
    window up to its ``n_valid``."""
    accepted, target = outs
    rows = np.flatnonzero(arrays["n_valid"] > 0)
    return [accepted[rows]] + [target[r, :arrays["n_valid"][r]] for r in rows]


def keep_sampled_round(arrays, outs):
    """``accepted`` of the rows in the round, and each one's ``emit`` up to
    ``accepted + 1`` (later slots hold proposals past the live window)."""
    accepted, emit = outs
    rows = np.flatnonzero(arrays["n_valid"] > 0)
    return [accepted[rows]] + [emit[r, :int(accepted[r]) + 1] for r in rows]


def keep_all(arrays, outs):
    return list(outs)


def _sample_twin(prog, record):
    """A sampler program checked call by call against ``sample_tokens``
    called eagerly on the same logits and inputs."""

    def call(logits, **arrays):
        out = prog(logits=logits, **arrays).clone()
        want = S.sample_tokens(logits, *S.from_staged(
            *(_dev(arrays[k]) for k in S.STAGED)))
        torch.cuda.synchronize()
        assert prog.graph is not None, f"{prog.name} was not captured"
        assert torch.equal(out, want), prog.name
        record.append(prog.name)
        return out

    return call


def _twin(prog, eager, caches, record, keep):
    """``prog`` checked call by call against ``eager(caches, **inputs)``
    on copies of ``caches`` taken just before the call; ``keep(arrays,
    outputs)`` picks the outputs that do not read the trash page."""

    def call(**arrays):
        before = [{n: b.clone() for n, b in c.items()} for c in caches]
        c0 = _build.launch_counts()
        out = prog(**arrays)
        outs = keep(arrays, [o.clone() for o in (
            out if isinstance(out, tuple) else (out,))])
        c1 = _build.launch_counts()
        want = eager(before, **{k: _dev(v) for k, v in arrays.items()})
        c2 = _build.launch_counts()
        want = keep(arrays, want if isinstance(want, tuple) else (want,))
        torch.cuda.synchronize()
        assert prog.graph is not None, f"{prog.name} was not captured"
        for got, w in zip(outs, want):
            assert got.shape == w.shape and torch.equal(got, w), prog.name
        for c, b in zip(caches, before):
            for n in c:  # the trash page (last) is written in no fixed order
                assert torch.equal(c[n][:, :-1], b[n][:, :-1]), (
                    f"{prog.name}: {n} pages")
        replayed = {c: c1[c] - c0[c] for c in c1 if c1[c] != c0[c]}
        eager_n = {c: c2[c] - c1[c] for c in c2 if c2[c] != c1[c]}
        assert replayed == eager_n and replayed, prog.name
        record.append(prog.name)
        return out

    return call


def _spies(eng):
    calls = {"clone": 0, "swap_in": 0}
    clone, swap_in = eng._clone_pages, eng._swap_in

    def spy_clone(s, d):
        calls["clone"] += 1
        clone(s, d)

    def spy_swap_in(req):
        calls["swap_in"] += 1
        swap_in(req)

    eng._clone_pages, eng._swap_in = spy_clone, spy_swap_in
    return calls


def _sampled(i):
    """Request ``i``'s sampling: one greedy request among sampled ones."""
    if i == 2:
        return SamplingParams()
    return SamplingParams(temperature=0.8, top_k=20 * (i % 2), top_p=0.95,
                          seed=2**31 + i)


def _drain(eng, max_new=10, sampled=False):
    reqs = [eng.submit(p, _sampled(i) if sampled else None,
                       max_new_tokens=max_new) for i, p in enumerate(PROMPTS)]
    eng.run_until_drained()
    assert all(r.done and len(r.generated) == max_new for r in reqs)
    return [list(r.generated) for r in reqs]


@pytest.mark.cuda
def test_serve_engine_replays_equal_eager(model):
    cfg, params, _ = model
    eng = ServeEngine(params, cfg, **KNOBS)
    kv, record = eng.kv.buffers, []
    eng._decode = _twin(
        eng._decode, lambda c, token, pos, table: MD.paged_decode_step(
            params, token, pos, table, c[0], cfg, compute_dtype=CD),
        [kv], record, keep_decode(eng.kv.trash))
    eng._prefill = _twin(
        eng._prefill, lambda c, tokens, start, n_valid, row:
        MD.paged_prefill_chunk(params, tokens, start, n_valid, row, c[0], cfg,
                               compute_dtype=CD), [kv], record, keep_all)
    calls = _spies(eng)
    streams = _drain(eng)
    assert calls["clone"] > 0 and calls["swap_in"] > 0, calls
    assert record.count("decode") == eng.stats["decode_calls"] > 1
    assert record.count("prefill") == eng.stats["prefill_calls"] > 1
    assert set(eng.stats["capture_s"]) == {"decode", "prefill"}
    assert min(eng.stats["graph_nodes"].values()) > 3 * cfg.num_layers
    cold = ServeEngine(params, cfg, **dict(KNOBS, num_pages=None,
                                           prefix_cache=False))
    assert _drain(cold) == streams


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fused", "scan"])
def test_speculative_engine_replays_equal_eager(model, backend):
    cfg, params, draft = model
    eng = SpeculativeEngine(params, cfg, draft, spec_k=SPEC_K,
                            verify_backend=backend, **KNOBS)
    caches, record = [eng.kv.buffers, eng.kv_draft.buffers], []
    eng._round_greedy = _twin(
        eng._round_greedy, lambda c, token, pos, n_valid, table: greedy_round(
            params, draft, token, pos, n_valid, table, c[0], c[1], cfg, cfg,
            SPEC_K, compute_dtype=CD, backend=backend), caches, record,
        keep_round)
    eng._prefill = _twin(
        eng._prefill, lambda c, tokens, start, n_valid, row: prefill_pair(
            params, draft, tokens, start, n_valid, row, c[0], c[1], cfg, cfg,
            compute_dtype=CD), caches, record, keep_all)
    calls = _spies(eng)
    FV.LAUNCHES.reset()
    _drain(eng)
    assert calls["clone"] > 0 and calls["swap_in"] > 0, calls
    assert eng.stats["corrections"] > 0  # the draft was rejected
    rounds = eng.stats["decode_calls"]
    assert record.count("round_greedy") == rounds > 1
    assert record.count("prefill_pair") == eng.stats["prefill_calls"]
    # the replays' verify launches, then as many from the eager twins
    per_round = cfg.num_layers if backend == "fused" else 0
    assert FV.LAUNCHES.n == 2 * per_round * rounds


@pytest.mark.cuda
def test_sampled_serve_replays_equal_eager(model):
    cfg, params, _ = model
    eng = ServeEngine(params, cfg, **KNOBS)
    record = []
    eng._decode = _twin(
        eng._decode, lambda c, token, pos, table: MD.paged_decode_step(
            params, token, pos, table, c[0], cfg, compute_dtype=CD),
        [eng.kv.buffers], record, keep_decode(eng.kv.trash))
    eng._sample_decode = _sample_twin(eng._sample_decode, record)
    eng._sample_prefill = _sample_twin(eng._sample_prefill, record)
    streams = _drain(eng, sampled=True)
    # a step whose rows are all greedy takes the argmax instead
    assert 1 < record.count("sample_decode") <= eng.stats["decode_calls"]
    assert record.count("sample_prefill") == len(PROMPTS) - 1
    assert {"sample_decode", "sample_prefill"} <= set(eng.stats["capture_s"])
    again = ServeEngine(params, cfg, **dict(KNOBS, num_pages=None,
                                            prefix_cache=False))
    assert _drain(again, sampled=True) == streams


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fused", "scan"])
def test_sampled_round_replays_equal_eager(model, backend):
    cfg, params, draft = model
    eng = SpeculativeEngine(params, cfg, draft, spec_k=SPEC_K,
                            verify_backend=backend, **KNOBS)
    caches, record = [eng.kv.buffers, eng.kv_draft.buffers], []

    def eager(c, token, pos, n_valid, table, seed, t, temperature, top_k,
              top_p):
        return sampled_round(params, draft, token, pos, n_valid, table,
                             *S.from_staged(seed, t, temperature, top_k,
                                            top_p),
                             c[0], c[1], cfg, cfg, SPEC_K, compute_dtype=CD,
                             backend=backend)

    eng._round = _twin(eng._round, eager, caches, record, keep_sampled_round)
    calls = _spies(eng)
    _drain(eng, sampled=True)
    assert calls["clone"] > 0 and calls["swap_in"] > 0, calls
    assert 1 < record.count("round") <= eng.stats["decode_calls"]
    assert eng.stats["corrections"] > 0
    assert eng.stats["graph_nodes"]["round"] > 0


@pytest.mark.cuda
def test_launch_counts_follow_replays(model):
    """After a drained serve, ``fused_lutmu`` counts 3 launches per layer
    per forward call, replays included, as ``chip_smoke.py`` checks."""
    cfg, params, _ = model
    eng = ServeEngine(params, cfg, **KNOBS)
    FL.LAUNCHES.reset()
    _drain(eng)
    calls = eng.stats["prefill_calls"] + eng.stats["decode_calls"]
    assert FL.LAUNCHES.n == 3 * cfg.num_layers * calls


@pytest.mark.cuda
def test_decode_read_launches_follow_replays(model):
    """The captured decode program reads the pages through the kernel once
    per layer (replays counted) and never through the plain read."""
    cfg, params, _ = model
    eng = ServeEngine(params, cfg, **KNOBS)
    FV.DECODE_LAUNCHES.reset()
    FV.PLAIN_DECODE_ON_CUDA.reset()
    _drain(eng)
    assert eng.stats["decode_calls"] > 1
    assert FV.DECODE_LAUNCHES.n == cfg.num_layers * eng.stats["decode_calls"]
    assert FV.PLAIN_DECODE_ON_CUDA.n == 0


@pytest.mark.cuda
def test_failed_capture_raises(model):
    cfg, params, _ = model
    x = torch.randn((4, 16, 4), device="cuda")
    thr = torch.randn((16, 15), device="cuda")
    lut = torch.randint(-128, 128, (16, 16, 64), dtype=torch.int8,
                        device="cuda")
    one = torch.ones((), device="cuda")

    def fn(a):
        out = FL.fused_lutmu(x, thr, lut, one, one)
        out.sum().item()  # a host read: not allowed inside a capture
        return out

    prog = StepProgram(fn, {"a": ((1,), 0)}, torch.device("cuda"), name="bad")
    before = FL.LAUNCHES.n
    with pytest.raises(RuntimeError):
        prog(a=np.zeros((1,), np.int32))
    assert prog.graph is None and FL.LAUNCHES.n == before
    # the device and the caller's stream carry on
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    assert float(torch.ones(3, device="cuda").sum()) == 3.0


def _observed(every=2):
    rec = Recorder(trace=True)
    rec.profiler = KernelProfiler(rec.registry, tracer=rec.tracer,
                                  every=every)
    return rec


def _as_program(call, prog):
    """The twin seen by the profiler as the program it wraps: it captures
    before timing and reads the program's cost (the program times itself
    by its own events)."""
    call.build, call.cost = prog.build, prog.cost
    return call


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plain", "spec-fused"])
def test_observed_replays_equal_eager(model, kind):
    cfg, params, draft = model
    rec = _observed()
    if kind == "plain":
        eng = ServeEngine(params, cfg, recorder=rec, **KNOBS)
        caches, record = [eng.kv.buffers], []
        progs = {"serve.decode": eng._decode, "serve.prefill": eng._prefill}
        eng._decode = _as_program(_twin(
            eng._decode, lambda c, token, pos, table: MD.paged_decode_step(
                params, token, pos, table, c[0], cfg, compute_dtype=CD),
            caches, record, keep_decode(eng.kv.trash)), eng._decode)
        eng._prefill = _as_program(_twin(
            eng._prefill, lambda c, tokens, start, n_valid, row:
            MD.paged_prefill_chunk(params, tokens, start, n_valid, row, c[0],
                                   cfg, compute_dtype=CD),
            caches, record, keep_all), eng._prefill)
    else:
        eng = SpeculativeEngine(params, cfg, draft, spec_k=SPEC_K,
                                verify_backend="fused", recorder=rec, **KNOBS)
        caches, record = [eng.kv.buffers, eng.kv_draft.buffers], []
        progs = {"spec.round_greedy": eng._round_greedy,
                 "spec.prefill_pair": eng._prefill}
        eng._round_greedy = _as_program(_twin(
            eng._round_greedy, lambda c, token, pos, n_valid, table:
            greedy_round(params, draft, token, pos, n_valid, table, c[0],
                         c[1], cfg, cfg, SPEC_K, compute_dtype=CD,
                         backend="fused"), caches, record, keep_round),
            eng._round_greedy)
        eng._prefill = _as_program(_twin(
            eng._prefill, lambda c, tokens, start, n_valid, row: prefill_pair(
                params, draft, tokens, start, n_valid, row, c[0], c[1], cfg,
                cfg, compute_dtype=CD), caches, record, keep_all),
            eng._prefill)
    calls = _spies(eng)
    streams = _drain(eng)
    assert calls["clone"] > 0 and calls["swap_in"] > 0, calls
    assert len(record) == (eng.stats["prefill_calls"]
                           + eng.stats["decode_calls"])
    v = rec.registry.value
    for site, prog in progs.items():
        assert prog.builds == 1 and prog.graph is not None, site
        assert v("jit_cache_misses_total", site=site) == 1, site
        assert rec.profiler.snapshot()["sites"][site]["count"] > 0, site
    assert v("kernel_profiled_steps_total") > 0
    assert v("serve_generated_tokens_total") == sum(map(len, streams))
    assert v("serve_evicted_total", kind="swap") > 0
    assert v("serve_cow_clones_total") > 0
    assert validate_prometheus(rec.to_prometheus()) == []
    assert validate_chrome_trace(rec.to_chrome()) == []
    cold = ServeEngine(params, cfg, **dict(KNOBS, num_pages=None,
                                           prefix_cache=False))
    if kind == "plain":
        assert _drain(cold) == streams


@pytest.mark.cuda
def test_profiled_step_syncs_and_unprofiled_does_not(model, monkeypatch):
    """(Named before the event timer: now neither kind syncs.)  Every
    program call of a profiled step becomes one ``kernels``-lane span of
    its step, resolved without a sync, its device time inside the host
    window around the call."""
    cfg, params, _ = model
    rec = _observed(every=2)
    eng = ServeEngine(params, cfg, recorder=rec, **KNOBS)
    # every program captured, the samplers too: a capture syncs on its own
    _drain(eng, sampled=True)
    rec.reset()
    n = [0]
    sync = torch.cuda.synchronize

    def counted(*args, **kwargs):
        n[0] += 1
        return sync(*args, **kwargs)

    calls = []  # (step, host seconds around the call) of profiled calls

    def watched(prog):
        def call(**arrays):
            t0 = time.perf_counter()
            out = prog(**arrays)
            torch.cuda.current_stream().synchronize()  # the host window
            if rec.profiler.active:
                calls.append((rec.profiler._step, time.perf_counter() - t0))
            return out
        return call

    progs = (eng._decode, eng._prefill)
    for attr in ("_decode", "_prefill", "_sample_decode", "_sample_prefill"):
        setattr(eng, attr, watched(getattr(eng, attr)))
    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    for i, p in enumerate(PROMPTS):
        eng.submit(p, _sampled(i), max_new_tokens=6)
    steps = []
    while eng.has_work:
        before = n[0]
        eng.step()
        steps.append((rec.profiler.active, n[0] - before))
    assert all(d == 0 for _, d in steps), steps
    assert any(active for active, _ in steps), steps
    spans = [e for e in rec.to_chrome()["traceEvents"] if e["ph"] == "X"
             and e["tid"] == Tracer.KERNEL_TID]
    assert [e["args"]["step"] for e in spans] == [s for s, _ in calls]
    for e, (_, host_s) in zip(spans, calls):
        assert 0 < e["dur"] <= 1e6 * host_s, (e, host_s)
    assert all(p.builds == 1 for p in progs)


def _tree_clone(t):
    return {k: _tree_clone(v) if isinstance(v, dict) else v.clone()
            for k, v in t.items()}


def _tree_equal(a, b):
    return all(_tree_equal(a[k], b[k]) if isinstance(a[k], dict)
               else torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-370m",
                                  "jamba-1.5-large-398b", "mixtral-8x7b"])
def test_fixed_engine_replays_equal_eager(model, arch):
    """Staggered admission into 3 slots, greedy and sampled requests, one
    cancelled while active: every ``fixed_decode`` replay bit-equal to
    eager ``MD.decode_step`` on a copy of the cache taken just before it,
    each sampler replay to ``sample_tokens``."""
    if arch == "qwen3-14b":
        cfg, params, _ = model
    else:
        cfg = get_config(arch, reduced=True)
        cfg = dataclasses.replace(cfg, amm=dataclasses.replace(
            cfg.amm, enabled=cfg.is_hybrid, backend="auto"))
        params = MD.init_params(cfg, torch.Generator(device="cuda")
                                .manual_seed(1), CD, serving=True)
    eng = FixedSlotEngine(params, cfg, slots=3, max_len=48,
                          compute_dtype=CD, device="cuda")
    prog, record = eng._decode, []

    def call(**arrays):
        before = _tree_clone(eng.cache)
        out = prog(**arrays)
        want = MD.decode_step(params, _dev(arrays["token"]),
                              _dev(arrays["pos"]), before, cfg,
                              compute_dtype=CD)
        torch.cuda.synchronize()
        assert prog.graph is not None
        assert torch.equal(out, want) and _tree_equal(eng.cache, before)
        record.append(1)
        return out  # the static output: the sampler reads it in place

    eng._decode = call
    s_log = []
    eng._sample_decode = _sample_twin(eng._sample_decode, s_log)
    hs = [eng.submit(p[:20], _sampled(i), max_new_tokens=6)
          for i, p in enumerate(PROMPTS)]
    eng.step()
    assert hs[1].cancel() and hs[1].status == "cancelled"
    eng.run_until_drained()
    assert all(h.done for h in hs) and not eng.has_work
    assert all(len(h.generated) == 6 for i, h in enumerate(hs) if i != 1)
    assert len(record) >= 6 and s_log, (len(record), s_log)
    assert eng.stats["graph_nodes"]["fixed_decode"] > 0


@pytest.mark.cuda
def test_sharded_train_step_on_1x1_nccl_mesh_is_single_device_bitwise():
    """Two steps of the sharded train step (``par``) on a 1x1 NCCL mesh
    equal two single-device steps bit for bit at reduced width (qwen3-14b,
    bf16 compute, ``grad_accum`` 2), both under deterministic algorithms:
    at 1x1 every collective is the identity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: an NCCL mesh has no CPU mode")
    import os

    import torch.distributed as dist

    from repro_torch import pytree as T
    from repro_torch.data import TokenStream
    from repro_torch.distributed.sharding import ParallelContext, shard_state
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.optim import cosine_schedule
    from repro_torch.runtime.steps import init_train_state, make_train_step

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = dataclasses.replace(get_config("qwen3-14b", reduced=True),
                              grad_accum=2)
    stream = TokenStream(vocab_size=cfg.vocab_size, batch_size=4, seq_len=32)

    def run(par=None, mesh=None):
        state = init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        if par is not None:
            state = shard_state(state, cfg, mesh)
        step = make_train_step(cfg, cosine_schedule(1e-2, 1, 10),
                               compute_dtype=CD, par=par)
        losses = []
        for i in range(2):
            state, m = step(state, {k: torch.from_numpy(v).cuda()
                                    for k, v in stream.batch(i).items()})
            losses.append(float(m["loss"]))
        return losses, T.leaves(state)

    mesh = make_serve_mesh("1x1", "cuda")
    torch.use_deterministic_algorithms(True)
    try:
        want = run()
        got = run(ParallelContext(cfg, mesh, init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(0)).params), mesh)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))

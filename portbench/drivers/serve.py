"""Driver of the served language-model cells: the port's paged engine
(``repro_torch.serving.load_engine`` → ``ServeEngine.step``) under a
traffic mix, measured from the client's side on the host clock.

Two loops, by the mix's ``arrival``:

- ``backlog``: every request is submitted at the start; the window opens
  once every decode row is busy and closes after the first step that ends
  ``seconds`` later.  ``tok_s`` counts the output tokens that reached the
  host in the window's steps over the window.
- ``poisson``: requests are submitted when due (the loop submits between
  engine steps and sleeps while the engine is idle); the window is the
  ``seconds`` after a warm-up of ``warmup_s``.  A request due in the window
  is timed from its due time to its first token on the host, however long
  that takes: the loop keeps serving the schedule until every such request
  has its first token, for at most ``tail_s`` (one that never gets it
  counts as failed, at the wait it had).  Token gaps are those whose later
  token reached the host inside the window.

Correctness: after the window, with the peak memory read and the engine
freed, the reference walks a sample of the finished greedy requests (the
longest among them) over their prompts and served tokens, and the widest
gap by which a served token's reference logit lies below the reference's
best at that position is compared with the cell's limit.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import sys
import time
from typing import Dict, List, Optional

import torch

from portbench import counts as K
from portbench.harness import device as D
from portbench.harness import result as R
from portbench.harness import trace as T
from portbench.harness import traffic as TR

TRACE_STEPS = 40       # engine steps under the profiler after a traced window
WARMUP_PROMPT = 8


class _Program:
    """A step program seen from the harness: each call inside a
    ``program.<name>`` host range, and with ``timed`` its device time by a
    pair of CUDA events on the current stream (read after the window)."""

    def __init__(self, prog, name: str, timed: bool):
        self.prog, self.name, self.timed = prog, name, timed
        self.calls: List = []   # (host time, in the traced slice, events)
        self.in_slice = False

    def __call__(self, **arrays):
        with _ranges(True)(f"program.{self.name}"):
            if not self.timed:
                return self.prog(**arrays)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.prog(**arrays)
            e.record()
        self.calls.append((time.perf_counter(), self.in_slice, s, e))
        return out

    def window_ms(self, t0: float, t1: float) -> List[float]:
        return [s.elapsed_time(e) for t, _, s, e in self.calls if t0 <= t <= t1]

    def slice_calls(self) -> int:
        return sum(1 for _, sl, _, _ in self.calls if sl)


def _ranges(traced: bool):
    """``record_function`` where the run is traced, else a no-op."""
    if traced:
        from torch.profiler import record_function
        return record_function
    return lambda name: contextlib.nullcontext()


def _sampling(spec):
    from repro_torch.serving import SamplingParams
    return None if spec is None else SamplingParams(**spec)


def _warm_up(engine, mix: Dict, vocab: int, seed: int) -> None:
    """Capture every step program the mix's traffic replays: a greedy
    request (prefill chunk, decode), and a sampled one beside it where the
    mix samples (the samplers of a prefill and of a decode batch)."""
    g = TR.rng(seed, "warm-up")
    reqs = [None] + ([dict(mix["sampling"], seed=1)] if mix.get("sampling")
                     else [])
    for sp in reqs:
        engine.submit(g.integers(0, vocab, size=WARMUP_PROMPT).tolist(),
                      _sampling(sp), max_new_tokens=3)
    engine.run_until_drained()
    for k, v in engine.stats.items():
        if isinstance(v, int):
            engine.stats[k] = 0


def _flops(sizes: Dict, prompt_len: int, pf0: int, pf1: int, g0: int,
           g1: int) -> float:
    """Dense-equivalent FLOPs of the work a request did while its prefilled
    tokens went from ``pf0`` to ``pf1`` and its served tokens from ``g0``
    to ``g1``: the prompt tokens (and the head of the first served token),
    then one decode token for each later served token."""
    fl = K.lm_span_flops(sizes, pf0, pf1 - pf0,
                         1 if (g0 == 0 and g1 >= 1) else 0)
    i0 = max(g0, 1)
    if g1 > i0:
        fl += K.lm_span_flops(sizes, prompt_len + i0 - 1, g1 - i0, g1 - i0)
    return fl


class _Loop:
    """The client loop: submits due requests, steps the engine, notes when
    each token reaches the host."""

    def __init__(self, engine, reqs: List[TR.Req], traced: bool):
        self.engine, self.reqs, self.traced = engine, reqs, traced
        self.handles: List = [None] * len(reqs)
        self.first: Dict[int, float] = {}
        self.last: Dict[int, float] = {}
        self.seen: Dict[int, int] = {}
        self.live: List[int] = []
        self.gaps: List = []            # (time, gap s) of every later token
        self.steps: List = []           # (t0, t1, prefills, decodes)
        self.late: List[float] = []     # submit time - due time
        self.next = 0
        self.origin = time.perf_counter()

    def submit_due(self, now: float) -> None:
        while (self.next < len(self.reqs)
               and self.reqs[self.next].due <= now - self.origin):
            r = self.reqs[self.next]
            self.handles[self.next] = self.engine.submit(
                r.prompt, _sampling(r.sampling), max_new_tokens=r.max_new)
            self.late.append(now - self.origin - r.due)
            self.live.append(self.next)
            self.seen[self.next] = 0
            self.next += 1

    def tick(self) -> None:
        record_function = _ranges(self.traced)
        eng = self.engine
        with record_function("harness.submit"):
            self.submit_due(time.perf_counter())
        if not eng.has_work:
            with record_function("harness.idle"):
                if self.next < len(self.reqs):
                    wait = self.origin + self.reqs[self.next].due - time.perf_counter()
                    time.sleep(min(max(wait, 0.0), 0.002))
            return
        pf, dc = eng.stats["prefill_calls"], eng.stats["decode_calls"]
        a = time.perf_counter()
        with record_function("harness.step"):
            eng.step()
        b = time.perf_counter()
        self.steps.append((a, b, eng.stats["prefill_calls"] - pf,
                           eng.stats["decode_calls"] - dc))
        still = []
        for i in self.live:
            h = self.handles[i]
            n = len(h.generated)
            if n > self.seen[i]:
                if i not in self.first:
                    self.first[i] = b
                else:
                    self.gaps.append((b, b - self.last[i]))
                self.last[i] = b
                self.seen[i] = n
            if not h.done:
                still.append(i)
        self.live = still

    def progress(self):
        """(prefilled, served) token counts of every submitted request."""
        return [(h.pf_done, len(h.generated)) if h is not None else (0, 0)
                for h in self.handles]


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> R.Outcome:
    from repro_torch.serving import Recorder, load_engine

    mod, sizes, mix = cell.config, cell.sizes, cell.mix
    knobs = mix["engine"]
    vocab = sizes["vocab_size"]
    on_card = device == "cuda"
    D.build_kernels(device)
    params = mod.make_params(sizes, seed, device)
    recorder = Recorder(trace=True) if trace else None
    engine = load_engine(None, params, mod.model_config(sizes),
                         compute_dtype=torch.bfloat16, device=device,
                         recorder=recorder, **knobs)
    _warm_up(engine, mix, vocab, seed)
    if recorder is not None:
        recorder.reset()
    progs = {}
    if trace:
        for attr, name, timed in (("_decode", "decode", on_card),
                                  ("_prefill", "prefill", on_card),
                                  ("_sample_decode", "sample_decode", False),
                                  ("_sample_prefill", "sample_prefill", False)):
            progs[name] = _Program(getattr(engine, attr), name, timed)
            setattr(engine, attr, progs[name])
    open_loop = mix["arrival"] == "poisson"
    warm = float(mix.get("warmup_s", 0.0))
    tail = float(mix.get("tail_s", 0.0))
    reqs = TR.generate(mix, seed, vocab, warm + seconds + tail)
    loop = _Loop(engine, reqs, trace)
    profiled = None

    def ticks(k, in_slice):
        def run():
            for p in progs.values():
                p.in_slice = in_slice
            for _ in range(k):
                loop.tick()
            for p in progs.values():
                p.in_slice = False
        return run

    if open_loop:
        w0 = loop.origin + warm
        while time.perf_counter() < w0:
            loop.tick()
    else:
        loop.submit_due(time.perf_counter())
        full = min(knobs["max_batch"], len(reqs))
        while sum(1 for h in loop.handles if h.generated and not h.done) < full:
            loop.tick()
        w0 = time.perf_counter()
    setup_s = w0 - t_start
    w1 = w0 + seconds
    prog0, prog1 = loop.progress(), None
    lo = len(loop.steps)
    due_in = [i for i, r in enumerate(reqs) if warm <= r.due < warm + seconds]
    problems: List[str] = []
    while True:
        now = time.perf_counter()
        if prog1 is None and (now >= w1 if open_loop else
                              len(loop.steps) > lo and loop.steps[-1][1] >= w1):
            # the work of the window's steps: those that began before w1
            prog1, hi = loop.progress(), len(loop.steps)
            if not open_loop:
                w1 = loop.steps[-1][1]
        if prog1 is not None and (
                not open_loop or now >= w1 + tail
                or all(i in loop.first for i in due_in)):
            break
        if loop.next == len(reqs) and not engine.has_work:
            if prog1 is None:
                problems.append("the traffic ran out before the window closed")
                prog1, hi = loop.progress(), len(loop.steps)
            break
        loop.tick()
    window = loop.steps[lo:hi]
    if trace and on_card:
        # after the window, under the same traffic (the schedule runs on)
        profiled = T.run_slice(torch, ticks(3, False), ticks(TRACE_STEPS, True))

    # -- what the window did ------------------------------------------------
    ctx: Dict = {"setup_s": setup_s, "window_s": w1 - w0,
                 "busy_s": sum(b - a for a, b, _, _ in window)}
    ctx["model_flops"] = sum(
        _flops(sizes, len(reqs[i].prompt), p0, p1, g0, g1)
        for i, ((p0, g0), (p1, g1)) in enumerate(zip(prog0, prog1)))
    if open_loop:
        end = time.perf_counter()
        ctx["ttft_s"] = [loop.first.get(i, end) - (loop.origin + reqs[i].due)
                         for i in due_in]
        ctx["itl_ms"] = [1e3 * g for t, g in loop.gaps if w0 <= t <= w1]
        attempted = len(due_in)
        failed = sum(1 for i in due_in if i not in loop.first)
    else:
        ctx["tokens_out"] = sum(g1 - g0 for (_, g0), (_, g1)
                                in zip(prog0, prog1))
        attempted = sum(1 for a, b in zip(prog0, prog1) if a != b)
        failed = 0
    late = sorted(loop.late)
    if late:
        print(f"[serve] generator lateness: median {late[len(late) // 2]:.4f}"
              f" s, max {late[-1]:.4f} s over {len(late)} submissions",
              file=sys.stderr, flush=True)
    if trace:
        ctx["step_host_ms"] = _step_host_ms(recorder, loop.steps, lo, hi)
        if open_loop:
            ctx["queue_wait_s"] = _queue_waits(recorder, loop, due_in)
        if on_card:
            ctx["replay_ms"] = {n: progs[n].window_ms(w0, w1)
                                for n in ("decode", "prefill")}
    dev = D.describe(cell.chips, device)
    sample = _sample(loop, reqs, knobs["max_batch"], seed, problems, vocab)
    slice_calls = {n: p.slice_calls() for n, p in progs.items()}
    del engine, loop, recorder, progs, ticks
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # -- the reference -------------------------------------------------------
    ref_mod = importlib.import_module(f"portbench.reference.{mod.REFERENCE}")
    codes = K.TableRows(2 ** sizes["lutmu"]["depth"]) if trace else None
    ref = ref_mod.Reference(params, sizes, max_batch=knobs["max_batch"],
                            max_len=knobs["max_len"],
                            chunk=knobs["prefill_chunk"], codes_seen=codes)
    t_ref = time.perf_counter()
    gap = _widest_gap(ref, sample, device)
    print(f"[check] the reference walked {len(sample)} requests, "
          f"{sum(len(g) for _, g in sample)} served tokens, in "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr, flush=True)
    checks = {"logit_gap": R.Check(gap, float(cell.limits["logit_gap"]))}
    dev_trace = T.reduce(profiled) if profiled is not None else None
    if dev_trace is not None:
        dev["busy_s"] = T.busy_s(dev_trace)
        dev["window_s"] = T.window_s(dev_trace)
        ctx["device_trace"] = dev_trace
        ctx["lutmu_bound_ms"] = _lutmu_bound_ms(sizes, knobs, codes,
                                                slice_calls)
    return R.Outcome(ctx=ctx, attempted=attempted, failed=failed,
                     checks=checks, problems=problems, device=dev,
                     breakdown=T.breakdown(dev_trace) if dev_trace else None,
                     check_inputs=(params, sample))


def _step_host_ms(recorder, steps, lo: int, hi: int) -> List[float]:
    """Host ms of each window step (``steps[lo:hi]``) outside the
    program-call spans the recorder opened in it (a decode dispatch on the
    engine lane, a prefill chunk on its request's lane), the spans taken in
    the order they were recorded."""
    spans = iter([e for e in recorder.tracer.events if e.get("ph") == "X"
                  and (e["name"] == "decode" and e["tid"] == 0
                       or e["name"].startswith("prefill["))])
    out = []
    for k, (a, b, pf, dc) in enumerate(steps[:hi]):
        inside = sum(next(spans)["dur"] for _ in range(pf + dc)) / 1e3
        if k >= lo:
            out.append(1e3 * (b - a) - inside)
    return out


def _queue_waits(recorder, loop: _Loop, due_in: List[int]) -> List[float]:
    """Seconds from submission to admission (the recorder's ``queued``
    spans) of the requests due in the window."""
    uid = {loop.handles[i].request_id: i for i in due_in}
    return [e["dur"] / 1e6 for e in recorder.tracer.events
            if e.get("ph") == "X" and e["name"] == "queued"
            and e["tid"] - 1 in uid]


def _sample(loop: _Loop, reqs, rows: int, seed: int, problems: List[str],
            vocab: int):
    """Up to ``rows`` finished greedy requests, the longest among them, the
    rest drawn from the seed; every served token is checked to lie in the
    vocabulary and every finished request to have its full budget."""
    done = []
    for i, h in enumerate(loop.handles):
        if h is None or not h.done:
            continue
        gen = list(h.generated)
        if any(not 0 <= t < vocab for t in gen):
            problems.append(f"request {i} served a token outside the vocabulary")
        if len(gen) != reqs[i].max_new:
            problems.append(f"request {i} finished with {len(gen)} of "
                            f"{reqs[i].max_new} tokens")
        if reqs[i].sampling is None:
            done.append((i, reqs[i].prompt, gen))
    if not done:
        problems.append("no greedy request finished")
        return []
    longest = max(range(len(done)), key=lambda k: len(done[k][2]))
    rest = [d for k, d in enumerate(done) if k != longest]
    order = TR.rng(seed, "check").permutation(len(rest))
    pick = [done[longest]] + [rest[k] for k in order[:rows - 1]]
    return [(p, g) for _, p, g in pick]


def _widest_gap(ref, sample, device, picks=None) -> float:
    """The widest gap by which a token's reference logit lies below the
    reference's best at its position: the served tokens, or at each
    position the token ``picks`` puts first (in the walk's order)."""
    if not sample:
        return float("inf")
    widest = torch.full((), -float("inf"), device=device)
    it = iter(picks) if picks is not None else None

    def on_logits(logits, targets, rows):
        nonlocal widest
        tok = targets if it is None else next(it)
        best = logits.max(dim=-1).values
        got = logits.gather(1, tok[:, None].to(torch.int64))[:, 0]
        widest = torch.maximum(widest, (best - got).max())

    with torch.inference_mode():
        ref.walk(sample, on_logits)
    return float(widest)


def control(cell, outcome: R.Outcome, device: str) -> float:
    """The control's reading on a run's own sample: the reference computed
    with float8 products (the precision below the configuration's bf16)
    picks the first token at each position of the same prompts and served
    tokens; the widest gap of those picks under the reference."""
    params, sample = outcome.check_inputs
    if not sample:
        raise ValueError("the run finished no greedy request to read")
    ref_mod = importlib.import_module(f"portbench.reference.{cell.config.REFERENCE}")
    knobs = cell.mix["engine"]

    def make(mm):
        return ref_mod.Reference(params, cell.sizes, max_batch=knobs["max_batch"],
                                 max_len=knobs["max_len"],
                                 chunk=knobs["prefill_chunk"], mm=mm)

    picks = []
    with torch.inference_mode():
        make(ref_mod.fp8_mm).walk(
            sample, lambda logits, t, r: picks.append(logits.argmax(dim=-1)))
    return _widest_gap(make(ref_mod.plain_mm), sample, device, picks)


def _lutmu_bound_ms(sizes: Dict, knobs: Dict, codes: K.TableRows,
                    calls: Dict[str, int]) -> Optional[float]:
    """Σ bound of the fused LUT-MU launches of the traced slice: per layer
    and forward, gate and up over the up-codebooks and down over the
    down-codebooks, at the step's rows (a decode batch, a prefill chunk),
    reading the share of table rows the reference's codes for calls of
    that shape read."""
    lm = sizes["lutmu"]
    d, ff, n_l = (sizes["hidden_size"], sizes["intermediate_size"],
                  sizes["num_hidden_layers"])
    depth, g = lm["depth"], 2 ** lm["depth"]
    c_up, c_down = d // lm["d_sub"], ff // lm["d_sub"]
    cols = depth * c_down
    total = 0.0
    for prog, rows in (("decode", knobs["max_batch"]),
                       ("prefill", knobs["prefill_chunk"])):
        n = calls.get(prog, 0)
        if not n:
            continue
        su, sd = codes.share(rows, c_up), codes.share(rows, c_down)
        if su is None or sd is None:
            return None
        per = (2 * K.lutmu_bound_ms(rows, c_up, cols, depth, 1, su * c_up * g)[0]
               + K.lutmu_bound_ms(rows, c_down, d, depth, 1, sd * c_down * g)[0])
        total += n * n_l * per
    return total

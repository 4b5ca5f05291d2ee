"""The serving step's own timeline in the port, on the CPU.

* Each step-program call of a traced engine opens one ``<name>.stage`` and
  one ``<name>.launch`` span on the ``programs`` lane, in that order, both
  inside the engine span around the call (``decode`` on the engine lane,
  ``prefill[i]`` on the request's).
* Each finished request has one ``first_token`` span (a B/E pair on its
  lane) from the end of its last ``queued`` span to its first token.
* Under a CPU ``torch.profiler``, the spans the program opens around its
  step programs are ``user_annotation`` ranges of the same names, in the
  same order, and the tracer's clock pair lays its timestamps onto the
  profiler's (the median start offset is within 200 µs).
* The kernel profiler's event path, with a fake CUDA event: pairs resolve
  at ``tick()`` once their end event has completed, ``flush()`` resolves
  the rest, the histogram counts the timed calls, the ``kernels`` lane
  gets one span per call with its step, and ``timed`` never syncs.
* With the ``NullRecorder`` the streams are those of a traced, profiled
  engine bit for bit, and nothing is recorded.
* ResNet-9's layers are profiler ranges, and its logits are the same with
  the profiler on.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import cnn as CNN
from repro_torch.models import model as MD
from repro_torch.serving import (FixedSlotEngine, KernelProfiler, Recorder,
                                 SamplingParams, ServeEngine,
                                 validate_chrome_trace)
from repro_torch.serving import obs as OBS
from repro_torch.serving.obs import Tracer

PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 2], [4, 4, 1, 1, 5, 6, 7],
           [3, 1], list(range(1, 21))]
# a pool too small for the request set: eviction, host swap, restarts
KNOBS = dict(max_batch=3, page_size=4, prefill_chunk=4, num_pages=8,
             max_len=64, device="cpu")
PROGRAM_SPANS = ("stage", "launch")


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen3-14b", reduced=True)
    cfg = dataclasses.replace(cfg, num_layers=2, d_model=64, d_ff=128,
                              vocab_size=64, num_heads=2, num_kv_heads=1,
                              head_dim=32)
    params = MD.init_params(cfg, torch.Generator().manual_seed(0),
                            serving=True)
    return cfg, params


def _sampling(i, sampled):
    if sampled and i % 2:
        return SamplingParams(temperature=0.8, top_k=8, seed=i)
    return None


def _serve(engine, sampled=False, max_new=5):
    handles = [engine.submit(p, _sampling(i, sampled), max_new_tokens=max_new)
               for i, p in enumerate(PROMPTS)]
    engine.run_until_drained()
    return [list(h.generated) for h in handles]


def _engine(kind, model, recorder=None):
    cfg, params = model
    if kind == "paged":
        return ServeEngine(params, cfg, recorder=recorder, **KNOBS)
    return FixedSlotEngine(params, cfg, slots=3, max_len=64, device="cpu",
                           recorder=recorder)


def _spans(trace, name=None, tid=None):
    return [e for e in trace["traceEvents"] if e["ph"] == "X"
            and (name is None or e["name"] == name)
            and (tid is None or e["tid"] == tid)]


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


class _Counted:
    """A step program seen through a wrapper, as a harness sees it."""

    def __init__(self, prog):
        self.prog, self.calls = prog, 0

    def __call__(self, **arrays):
        self.calls += 1
        return self.prog(**arrays)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_each_program_call_one_stage_and_one_launch(model, sampled):
    rec = Recorder()
    eng = _engine("paged", model, rec)
    progs = {}
    for attr in ("_decode", "_prefill", "_sample_decode", "_sample_prefill"):
        progs[getattr(eng, attr).name] = _Counted(getattr(eng, attr))
        setattr(eng, attr, progs[getattr(eng, attr).name])
    _serve(eng, sampled)
    trace = rec.to_chrome()
    assert validate_chrome_trace(trace) == []
    lane = _spans(trace, tid=Tracer.PROGRAM_TID)
    assert lane and all(e["name"].rsplit(".", 1)[1] in PROGRAM_SPANS
                        for e in lane)
    for name, counted in progs.items():
        for part in PROGRAM_SPANS:
            got = sum(e["name"] == f"{name}.{part}" for e in lane)
            assert got == counted.calls, (name, part)
    assert progs["decode"].calls and progs["prefill"].calls
    # an all-greedy step takes the argmax without a sampler program
    assert bool(progs["sample_decode"].calls) == sampled
    # stage then launch, back to back, one pair per call
    for stage, launch in zip(lane[::2], lane[1::2]):
        assert stage["name"].endswith(".stage")
        assert launch["name"] == stage["name"][:-len("stage")] + "launch"
        assert stage["ts"] + stage["dur"] <= launch["ts"]
    outers = (_spans(trace, "decode", Tracer.ENGINE_TID)
              + [e for e in _spans(trace) if e["name"].startswith("prefill[")])
    for outer in outers:
        main = "decode" if outer["name"] == "decode" else "prefill"
        inner = [e for e in lane if _inside(e, outer)]
        assert [e["name"] for e in inner[:2]] == [f"{main}.stage",
                                                  f"{main}.launch"]
    for e in lane:
        assert sum(_inside(e, o) for o in outers) == 1, e


@pytest.mark.parametrize("kind", ["paged", "fixed"])
def test_each_finished_request_one_first_token_span(model, kind):
    rec = Recorder()
    eng = _engine(kind, model, rec)
    handles = [eng.submit(p, max_new_tokens=5) for p in PROMPTS]
    eng.run_until_drained()
    trace = rec.to_chrome()
    assert validate_chrome_trace(trace) == []
    for h in handles:
        lane = h.request_id + 1
        pair = [e for e in trace["traceEvents"] if e["tid"] == lane
                and e["name"] == "first_token"]
        assert [e["ph"] for e in pair] == ["B", "E"], pair
        queued = _spans(trace, "queued", lane)[-1]
        assert pair[0]["ts"] == pytest.approx(queued["ts"] + queued["dur"],
                                              abs=2e-3)
        last = [e for e in _spans(trace, tid=lane)
                if e["name"].startswith("prefill[")][-1]
        # the last prefill span ends at the first token
        assert pair[1]["ts"] == pytest.approx(last["ts"] + last["dur"],
                                              abs=2e-3)
        assert pair[0]["ts"] <= last["ts"]


def test_profiler_ranges_mirror_spans_on_one_clock(model, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    rec = Recorder()
    eng = _engine("paged", model, rec)
    eng.submit(PROMPTS[0], max_new_tokens=2)
    eng.run_until_drained()  # every program built before the profiler
    rec.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(eng, sampled=True)
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    ptrace = json.loads(path.read_text())
    trace = rec.to_chrome()

    def mirrored(name):
        return (name.startswith("prefill[")
                or name.rsplit(".", 1)[-1] in PROGRAM_SPANS)

    # the program's spans in the order they were opened; ``decode`` is
    # also on each request's lane, once a step on the engine's
    spans = sorted((e for e in _spans(trace) if mirrored(e["name"]) or (
        e["name"] == "decode" and e["tid"] == Tracer.ENGINE_TID)),
        key=lambda e: (e["ts"], -e["dur"]))
    # the ranges in the order they were entered (the profiler numbers them
    # as it records; their timestamps are its own clock's)
    ranges = sorted((e for e in ptrace["traceEvents"]
                     if e.get("cat") == "user_annotation"
                     and (e["name"] == "decode" or mirrored(e["name"]))),
                    key=lambda e: e["args"]["External id"])
    assert {"decode", "prefill[0]", "decode.stage", "decode.launch",
            "prefill.stage", "prefill.launch", "sample_decode.stage",
            "sample_decode.launch"} <= {e["name"] for e in spans}
    assert [r["name"] for r in ranges] == [s["name"] for s in spans]
    # mapped through the clock pair, the spans start where the ranges do
    offset = OBS.profiler_offset_us(trace, ptrace)
    starts = [s["ts"] + offset - r["ts"] for r, s in zip(ranges, spans)]
    assert abs(float(np.median(starts))) <= 200, starts


class _FakeDevice:
    """Device time and completion for :class:`_FakeEvent`."""
    now_ms = 0.0
    done_upto = 0  # events with a serial at or below this have completed
    serial = 0


class _FakeEvent:
    def __init__(self, enable_timing=False):
        self.t = None
        self.seq = None

    def record(self, stream=None):
        _FakeDevice.serial += 1
        self.seq = _FakeDevice.serial
        self.t = _FakeDevice.now_ms

    def query(self):
        return self.seq <= _FakeDevice.done_upto

    def synchronize(self):
        _FakeDevice.done_upto = max(_FakeDevice.done_upto, self.seq)

    def elapsed_time(self, end):
        assert self.query() and end.query(), "read before it completed"
        return end.t - self.t


class _FakeProgram:
    """A step program on the card as the profiler sees it: a start event
    recorded before its copy, device time passing, the pair handed back."""

    device = torch.device("cuda")

    def __init__(self, name, prof, ms):
        self.name, self.prof, self.ms = name, prof, ms

    def __call__(self):
        start = self.prof.start_event(self.device)
        if start is not None:
            start.record()
        _FakeDevice.now_ms += self.ms
        if start is not None:
            self.prof.program_call(self.name, start)


@pytest.fixture
def fake_cuda(monkeypatch):
    syncs = []
    monkeypatch.setattr(_FakeDevice, "now_ms", 0.0)
    monkeypatch.setattr(_FakeDevice, "done_upto", 0)
    monkeypatch.setattr(_FakeDevice, "serial", 0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(1))
    return syncs


def test_kernel_profiler_resolves_event_pairs_without_sync(fake_cuda):
    syncs = fake_cuda
    rec = Recorder()
    rec.profiler = KernelProfiler(rec.registry, tracer=rec.tracer, every=1)
    prof = rec.profiler
    assert len(syncs) == 1  # the anchor, at attach
    decode = _FakeProgram("decode", prof, 5.0)
    sample = _FakeProgram("sample_decode", prof, 0.5)

    def step(gap_ms):
        prof.tick()
        prof.timed("serve.decode", decode)
        sample()  # an untimed program call of the step
        _FakeDevice.now_ms += gap_ms

    step(1.0)
    assert len(prof._pending) == 2
    step(2.0)  # nothing completed yet: nothing resolves
    assert len(prof._pending) == 4
    # the first step's two pairs completed: serials 1 (the anchor), then
    # per step 5 (``timed``'s own start, unused as the program hands its
    # pair, and two pairs)
    _FakeDevice.done_upto = 6
    step(3.0)
    assert len(prof._pending) == 4
    hist = rec.registry.find("kernel_latency_seconds")[0]
    assert hist.count == 1 and hist.sum == pytest.approx(5e-3)
    assert len(syncs) == 1  # ``timed`` and ``tick`` never sync
    prof.end_step(has_work=False)
    prof.flush()  # resolves the rest
    assert not prof._pending and hist.count == 3
    spans = _spans(rec.tracer.to_chrome(), tid=Tracer.KERNEL_TID)
    assert [(e["name"], e["args"]["step"]) for e in spans] == [
        ("serve.decode", 1), ("sample_decode", 1), ("serve.decode", 2),
        ("sample_decode", 2), ("serve.decode", 3), ("sample_decode", 3)]
    assert [e["dur"] for e in spans] == pytest.approx([5e3, 5e2] * 3)
    assert spans[-1]["args"].get("drained") is True
    assert not any(e["args"].get("drained") for e in spans[:-1])
    # the device gaps between calls, 0 inside a step, are kept
    gaps = [b["ts"] - (a["ts"] + a["dur"]) for a, b in zip(spans, spans[1:])]
    assert gaps == pytest.approx([0, 1e3, 0, 2e3, 0], abs=0.05)
    assert validate_chrome_trace(rec.tracer.to_chrome()) == []


def _eager(ms):
    """Eager code behind a wrapper: device time, no pair of its own."""
    def call(**arrays):
        _FakeDevice.now_ms += ms
    return call


def test_timed_pairs_a_call_that_hands_none_on_the_card(fake_cuda):
    syncs = fake_cuda
    rec = Recorder()
    rec.profiler = KernelProfiler(rec.registry, tracer=rec.tracer, every=1)
    for _ in range(2):
        rec.profiler.tick()
        rec.profiler.timed("serve.decode", _eager(3.0))
    rec.profiler.flush()
    hist = rec.registry.find("kernel_latency_seconds")[0]
    assert hist.count == 2 and hist.sum == pytest.approx(6e-3)
    spans = _spans(rec.tracer.to_chrome(), tid=Tracer.KERNEL_TID)
    assert [(e["name"], e["dur"]) for e in spans] == [
        ("serve.decode", pytest.approx(3e3))] * 2
    assert len(syncs) == 1  # the anchor only


def test_timed_on_the_cpu_reads_the_host_clock():
    now = [0.0]
    rec = Recorder(clock=lambda: now[0])
    rec.profiler = KernelProfiler(rec.registry, tracer=rec.tracer, every=1,
                                  clock=rec.now)
    now[0] = 1.0

    def call():  # a program on the CPU: its work is done when it returns
        now[0] += 0.25
    call.device = torch.device("cpu")
    rec.profiler.tick()
    rec.profiler.timed("serve.decode", call)
    hist = rec.registry.find("kernel_latency_seconds")[0]
    assert hist.count == 1 and hist.sum == pytest.approx(0.25)
    spans = _spans(rec.tracer.to_chrome(), tid=Tracer.KERNEL_TID)
    assert [(e["ts"], e["dur"]) for e in spans] == [(1e6, 2.5e5)]


def test_kernel_profiler_unprofiled_step_records_no_events(fake_cuda):
    rec = Recorder()
    rec.profiler = KernelProfiler(rec.registry, tracer=rec.tracer, every=2)
    prog = _FakeProgram("decode", rec.profiler, 5.0)
    for _ in range(4):
        rec.profiler.tick()
        if rec.profiler.active:
            rec.profiler.timed("serve.decode", prog)
        else:
            prog()
    rec.profiler.flush()
    spans = _spans(rec.to_chrome(), tid=Tracer.KERNEL_TID)
    assert [e["args"]["step"] for e in spans] == [2, 4]
    assert rec.profiler.snapshot()["sites"]["serve.decode"]["count"] == 2


def test_recorder_reset_drops_pending_and_reanchors(fake_cuda):
    syncs = fake_cuda
    rec = Recorder()
    rec.profiler = KernelProfiler(rec.registry, tracer=rec.tracer, every=1)
    prog = _FakeProgram("decode", rec.profiler, 5.0)
    rec.profiler.tick()
    rec.profiler.timed("serve.decode", prog)
    rec.reset()
    assert not rec.profiler._pending and len(syncs) == 2
    assert rec.profiler.snapshot()["sites"] == {}


@pytest.mark.parametrize("kind,sampled", [("paged", False), ("paged", True),
                                          ("fixed", True)])
def test_null_recorder_streams_equal_and_nothing_recorded(model, kind,
                                                          sampled,
                                                          monkeypatch):
    rec = Recorder()
    rec.profiler = KernelProfiler(rec.registry, tracer=rec.tracer, every=1)
    traced = _serve(_engine(kind, model, rec), sampled)
    assert _spans(rec.to_chrome(), tid=Tracer.PROGRAM_TID)
    recorded = []
    for cls, hook in ((Tracer, "span"), (Tracer, "enclosing"),
                      (Tracer, "instant"), (Recorder, "span")):
        monkeypatch.setattr(cls, hook, lambda *a, **k: recorded.append(a))
    monkeypatch.setattr(KernelProfiler, "start_event",
                        lambda *a, **k: recorded.append(a))
    eng = _engine(kind, model)
    assert not eng.obs and not eng._decode.obs
    assert _serve(eng, sampled) == traced
    assert recorded == []


def test_resnet9_layers_are_profiler_ranges_and_values_hold():
    from torch.profiler import ProfilerActivity, profile
    params = CNN.init_resnet9(CNN.ResNet9Config(channels=(8, 16, 16, 32)),
                              torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    off = CNN.resnet9_forward(params, x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = CNN.resnet9_forward(params, x)
    assert torch.equal(on, off)
    names = [e.name for e in prof.events()]
    layers = CNN.CONV_ORDER + ("pool1", "pool2", "pool3", "head")
    assert all(names.count(n) == 1 for n in layers), names


def test_annotate_is_one_shared_no_op_when_the_profiler_is_off():
    from repro_torch.annotate import annotate
    assert annotate("a") is annotate("b")
    with annotate("a"):
        pass


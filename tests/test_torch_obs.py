"""The port's observability layer against the live JAX package.

**Host modules.**  The same scripted hook sequence, under a fake clock,
goes to ``repro.serving.obs.Recorder`` (with the JAX ``KernelProfiler``)
and to the port's: the Prometheus expositions are byte-equal, the Chrome
traces equal once the port's own additions are left out (each request's
``first_token`` B/E pair and the tracer's clock pair in ``otherData``),
and so are the SLO snapshot, ``slo_report``,
``summary_table`` and the profiler snapshot.  The validators give the JAX
verdicts on malformed inputs.  The unit tests of ``tests/test_obs.py``
(registry, histograms, tracer, ``NullRecorder``, logger, SLO tracker)
run on the port's classes.

**Engines.**  On the golden tiny setup (2 layers, d_model 64, JAX params
carried across with ``convert.params_from_jax``) the plain engine — under
eviction, with prefix sharing, greedy and sampled — and the speculative
engine on float and int8 KV (an identical draft, and a garbage one that
is rejected and rolls back) serve the same requests with the recorder,
the kernel profiler (every 2nd step) and the quality probe on and off:
streams are bit-equal.  Every Prometheus sample that is not a clock
reading equals the JAX engine's with the same attachments on the same
requests: counters, gauges and histogram ``_count``s; a seconds
histogram is compared by its ``_count`` only.  Left out, with the reason:

  * ``jit_cache_misses_total{site="sampling.sample_tokens"}`` — JAX's
    sampler is one module-level jitted function shared by every engine in
    the process, so its count depends on what earlier engines compiled;
    the port has one sampler program per engine and batch shape, and an
    all-greedy step takes the argmax without calling it.  The
    ``serve.decode``, ``serve.prefill`` and ``spec.*`` sites are compared.
  * ``kernel_flops`` / ``kernel_bytes`` — XLA's cost analysis in JAX, the
    port's own count (``profiler.py::forward_cost``) here; a hand count
    pins it below.

**Profiler.**  ``every < 1`` is refused, ``kernel_profiled_steps_total``
is steps // every, the dispatch hook counts one call and stops after
detach, and a hand count pins ``forward_cost`` at the tiny config.
"""
import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JMD
from repro.serving import KernelProfiler as JKernelProfiler
from repro.serving import QualityProbe as JQualityProbe
from repro.serving import Recorder as JRecorder
from repro.serving import ServeEngine as JServeEngine
from repro.serving import SpeculativeEngine as JSpeculativeEngine
from repro.serving import obs as JOBS
from repro_torch.convert import config_from_jax, params_from_jax
from repro_torch.serving import (NULL_RECORDER, KernelProfiler,
                                 MetricsRegistry, NullRecorder, QualityProbe,
                                 Recorder, SamplingParams, ServeEngine,
                                 SloThresholds, SloTracker, SpeculativeEngine,
                                 attach_dispatch_hook, slo_report,
                                 summary_table, validate_chrome_trace,
                                 validate_prometheus)
from repro_torch.serving import obs as OBS
from repro_torch.serving.obs import Counter, Histogram, Tracer, log, log_enabled
from repro_torch.serving.profiler import forward_cost

PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 2], [4, 4, 1, 1, 5, 6, 7],
           [3, 1], list(range(1, 21))]
STEM = [5, 1, 4, 1, 5, 9, 2, 6, 5, 3]
PREFIX_PROMPTS = [STEM + [7, 7, 7], STEM + [7, 7, 7], STEM + [8, 8],
                  STEM[:6] + [9, 9, 9, 9], [2, 7, 1, 8, 2, 8]]
# a pool too small for the request set: eviction with host swap
EVICT_KWARGS = dict(max_batch=3, page_size=4, prefill_chunk=4, num_pages=8,
                    max_len=64)
SPEC_KWARGS = dict(spec_k=3, max_batch=3, max_len=64, page_size=4,
                   prefill_chunk=4, num_pages=12)


def _tiny_cfg(int8_kv=False):
    cfg = get_config("qwen3-14b", reduced=True)
    cfg = dataclasses.replace(cfg, num_layers=2, d_model=64, d_ff=128,
                              vocab_size=64, num_heads=2, num_kv_heads=1,
                              head_dim=32)
    if int8_kv:
        cfg = dataclasses.replace(cfg, amm=dataclasses.replace(
            cfg.amm, enabled=True, kv_int8=True))
    return cfg


def _to_port(params):
    return params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def setup():
    cfg = _tiny_cfg()
    params = JMD.init_params(cfg, jax.random.PRNGKey(0))
    garbage = JMD.init_params(cfg, jax.random.PRNGKey(99))
    return dict(cfg=cfg, params=params, garbage=garbage,
                tcfg=config_from_jax(cfg), tparams=_to_port(params),
                tgarbage=_to_port(garbage))


# ---------------------------------------------------------------------------
# Host modules: one scripted hook sequence through both packages.
# ---------------------------------------------------------------------------


def _fake_clock():
    t = [100.0]

    def clock():
        t[0] += 0.00125
        return t[0]

    return clock


class _Req:
    def __init__(self, uid):
        self.uid = uid


class _Alloc:
    in_use = 5

    def free_pages(self):
        return [0, 1, 3, 4, 7, 8, 9]


class _Site:
    """A dispatch site both recorders can probe: JAX reads
    ``_cache_size()``, the port ``builds``."""

    def __init__(self):
        self.builds = 0

    def _cache_size(self):
        return self.builds

    def __call__(self):
        return 0


def _script(obs, profiler_cls):
    """Drive every recorder hook in a fixed order under a fake clock."""
    clock = _fake_clock()
    rec = obs.Recorder(trace=True, clock=clock)
    rec.profiler = profiler_cls(rec.registry, tracer=rec.tracer, every=2,
                                clock=clock)
    site = _Site()
    rec.register_jit_site("serve.decode", site)
    rec.register_jit_site("no.probe", lambda: None)
    reqs = [_Req(i) for i in range(4)]
    for r in reqs:
        rec.on_submit(r)
    rec.on_admit(reqs[0])
    rec.on_prefix_lookup(0, 0, False)
    t0 = rec.now()
    rec.on_prefill(reqs[0], 0, 4, t0, rec.now())
    t0 = rec.now()
    rec.on_prefill(reqs[0], 1, 3, t0, rec.now())
    rec.on_tokens(reqs[0], 1, rec.now(), source="prefill")
    rec.on_admit(reqs[1])
    rec.on_prefix_lookup(8, 2, True)
    rec.on_cow_clone(4096)
    rec.on_tokens(reqs[1], 1, rec.now(), source="prefill")
    rec.on_tokens(reqs[2], 0, rec.now())
    for step in range(5):
        if rec.profiler.tick():
            rec.profiler.timed("serve.decode", site)
        site.builds += step in (0, 3)
        t0 = rec.now()
        rec.on_decode([(0, reqs[0]), (1, reqs[1])], t0, rec.now())
        rec.on_tokens(reqs[0], 1, rec.now())
        rec.on_tokens(reqs[1], 1, rec.now())
        rec.sample_pool(_Alloc())
        rec.poll_jit()
    rec.on_alloc(3)
    rec.on_alloc_fail(2)
    rec.on_free(1)
    rec.on_rollback(2)
    rec.on_rollback(0)
    rec.on_evict(reqs[1], "swap")
    rec.on_swap_bytes("out", 1024)
    rec.on_resume(reqs[1])
    rec.on_swap_bytes("in", 1024)
    rec.on_admit(reqs[2])
    rec.on_evict(reqs[2], "restart")
    rec.on_prefix_evict(3)
    rec.on_spec_round("greedy")
    rec.on_spec_round("sampled")
    rec.on_spec_row(3, 2, 1, 0, 3)
    rec.on_spec_row(3, 3, 0, 1, 4)
    t0 = rec.now()
    rec.on_decode([(0, reqs[1])], t0, rec.now(), name="spec-round")
    rec.on_tokens(reqs[1], 4, rec.now())
    rec.on_request_id(reqs[3], 'corr "7"\\x')
    rec.on_cancel(reqs[3])
    rec.on_cancel(reqs[2])
    rec.on_finish(reqs[0])
    rec.on_finish(reqs[1])
    rec.registry.counter("h_total", "hostile", path='a"b\\c\nd').inc()
    return rec


@pytest.fixture(scope="module")
def scripted():
    return _script(JOBS, JKernelProfiler), _script(OBS, KernelProfiler)


def _jax_view(trace):
    """The port's trace without what the JAX package does not record: the
    ``first_token`` B/E pairs and the clock pair."""
    other = {k: v for k, v in trace["otherData"].items() if k != "clock_pair"}
    return dict(trace, otherData=other, traceEvents=[
        e for e in trace["traceEvents"] if e["name"] != "first_token"])


def test_exports_byte_equal_to_reference(scripted):
    ref, port = scripted
    text = port.to_prometheus()
    assert text == ref.to_prometheus()
    assert validate_prometheus(text) == []
    assert _jax_view(port.to_chrome()) == ref.to_chrome()
    assert json.dumps(_jax_view(port.to_chrome())) == json.dumps(
        ref.to_chrome())
    assert validate_chrome_trace(port.to_chrome()) == []


def test_reports_equal_to_reference(scripted):
    ref, port = scripted
    assert port.slo.snapshot() == ref.slo.snapshot()
    assert slo_report(port.slo) == JOBS.slo_report(ref.slo)
    assert summary_table(port.registry) == JOBS.summary_table(ref.registry)
    assert port.profiler.snapshot() == ref.profiler.snapshot()
    assert port.registry.value("jit_cache_misses_total",
                               site="serve.decode") == 2


@pytest.mark.parametrize("thresholds", [
    dict(),
    dict(ttft_p99_s=0.001, tpot_p99_s=0.001, min_tok_s=1e6,
         min_acceptance=0.99, budget_target=0.9),
], ids=["default", "violated"])
def test_slo_tracker_equal_to_reference(thresholds):
    def run(obs):
        r = obs.MetricsRegistry()
        slo = obs.SloTracker(r, clock=lambda: 100.0, window_s=30.0,
                             thresholds=obs.SloThresholds(**thresholds))
        for ts in (60.0, 85.0, 95.0):
            slo.note_tokens(ts, 30)
            slo.note_ttft(ts, 0.002 * ts)
            slo.note_tpot(ts, 0.0001 * ts)
            slo.note_acceptance(ts, proposed=10, accepted=int(ts) % 7)
        r.counter("spec_proposed_total").inc(40)
        r.counter("spec_accepted_total").inc(30)
        out = [slo.snapshot(now=100.0), slo.snapshot(now=140.0)]
        return out, obs.slo_report(slo), r.to_prometheus()

    assert run(OBS) == run(JOBS)


_BAD_PROM = [
    "9bad_name 1\n",
    "x_total nan-ish\n",
    "# BOGUS comment\n",
    'h_bucket{le="1.0"} 3\nh_bucket{le="2.0"} 2\nh_bucket{le="+Inf"} 3\n',
    'h_bucket{le="1.0"} 3\n',
    'x{a="1"',
    "x_total{} 1\n",
    "ok_total 1\n",
]
_BAD_TRACE = [
    {},
    {"traceEvents": [
        {"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0, "dur": 10.0},
        {"name": "b", "ph": "X", "pid": 1, "tid": 1, "ts": 5.0, "dur": 10.0}]},
    {"traceEvents": [
        {"name": "a", "ph": "i", "s": "t", "pid": 1, "tid": 1, "ts": 5.0},
        {"name": "b", "ph": "i", "s": "t", "pid": 1, "tid": 1, "ts": 1.0}]},
    {"traceEvents": [{"name": "a", "ph": "Q", "pid": 1, "tid": 1, "ts": 0}]},
    {"traceEvents": [{"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 1}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "dur": 1}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0,
                      "dur": 2.0},
                     {"name": "b", "ph": "X", "pid": 1, "tid": 2, "ts": 1,
                      "dur": 2.0}]},
]


@pytest.mark.parametrize("text", _BAD_PROM)
def test_prometheus_validator_agrees_with_reference(text):
    assert validate_prometheus(text) == JOBS.validate_prometheus(text)


@pytest.mark.parametrize("obj", _BAD_TRACE)
def test_trace_validator_agrees_with_reference(obj):
    assert validate_chrome_trace(obj) == JOBS.validate_chrome_trace(obj)


def test_validator_cli(tmp_path, scripted, capsys):
    _, port = scripted
    m, t = tmp_path / "m.prom", tmp_path / "t.json"
    port.write_metrics(m)
    port.write_trace(t)
    assert OBS._main(["--metrics", str(m), "--trace", str(t)]) == 0
    out = capsys.readouterr().out
    assert "metrics OK" in out and "trace OK" in out
    m.write_text("9bad 1\n")
    assert OBS._main(["--metrics", str(m)]) == 1
    assert "INVALID" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The unit tests of tests/test_obs.py on the port's classes.
# ---------------------------------------------------------------------------


def test_counter_is_monotonic():
    c = Counter("x_total")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError, match="decrease"):
        c.inc(-1)


def test_histogram_buckets_and_quantiles():
    h = Histogram("lat_seconds", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0):
        h.observe(v)
    assert h.count == 4 and h.counts == [1, 2, 1, 0]
    assert h.sum == pytest.approx(6.05)
    assert h.mean == pytest.approx(6.05 / 4)
    assert 0.1 <= h.quantile(0.5) <= 1.0
    assert h.quantile(0.99) > 1.0
    h.observe(100.0)
    assert h.counts[-1] == 1
    with pytest.raises(ValueError, match="sorted"):
        Histogram("bad", buckets=(1.0, 0.1))


def test_histogram_quantile_edge_cases():
    h = Histogram("h", buckets=(0.1, 1.0))
    assert h.quantile(0.0) == 0.0 and h.quantile(0.5) == 0.0
    assert h.mean == 0.0
    h.observe(0.05)
    assert h.quantile(0.0) == 0.0
    assert h.quantile(1.0) == pytest.approx(0.1)
    assert h.quantile(-3.0) == h.quantile(0.0)
    assert h.quantile(7.0) == h.quantile(1.0)
    top = Histogram("t", buckets=(0.1, 1.0))
    top.observe(50.0)
    assert top.counts[-1] == 1
    assert top.quantile(0.5) == 1.0 and top.quantile(0.99) == 1.0
    assert top.mean == 50.0


def test_registry_prometheus_exposition():
    r = MetricsRegistry()
    r.counter("req_total", "requests", kind="a").inc(3)
    r.counter("req_total", "requests", kind="b").inc()
    r.gauge("pool_free", "free pages").set(7)
    h = r.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    text = r.to_prometheus()
    assert validate_prometheus(text) == []
    for line in ('# TYPE req_total counter', 'req_total{kind="a"} 3',
                 'pool_free 7', 'lat_seconds_bucket{le="0.1"} 1',
                 'lat_seconds_bucket{le="+Inf"} 2', 'lat_seconds_count 2'):
        assert line in text
    assert r.value("req_total", kind="a") == 3
    assert r.sum_values("req_total") == 4
    with pytest.raises(ValueError, match="registered"):
        r.gauge("req_total")
    with pytest.raises(ValueError, match="invalid metric name"):
        r.counter("9lives")


def test_prometheus_hostile_label_values():
    r = MetricsRegistry()
    r.counter("h_total", "hostile", path='a"b\\c\nd').inc()
    text = r.to_prometheus()
    assert validate_prometheus(text) == []
    assert 'h_total{path="a\\"b\\\\c\\nd"} 1' in text
    for line in text.splitlines():
        if line.startswith("h_total"):
            assert line.endswith(" 1")


def test_tracer_lanes_and_export():
    clock = _fake_clock()
    tr = Tracer(clock=clock)
    tr.span(1, "queued", 200.0, 201.0)
    tr.span(Tracer.ENGINE_TID, "decode", 201.0, 202.0, rows=2)
    tr.span(Tracer.KERNEL_TID, "serve.decode", 201.0, 201.5)
    obj = tr.to_chrome()
    assert validate_chrome_trace(obj) == []
    names = {e["args"]["name"] for e in obj["traceEvents"] if e["ph"] == "M"}
    assert names == {"engine", "req 0", "kernels"}
    spans = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    assert [s["name"] for s in spans] == ["queued", "decode", "serve.decode"]
    assert spans[1]["args"]["rows"] == 2
    tr.reset()
    assert tr.to_chrome()["traceEvents"] == []


def test_null_recorder_noop_guarantee():
    n = NULL_RECORDER
    assert isinstance(n, NullRecorder)
    assert not n and n.enabled is False
    assert n.on_submit(object()) is None
    assert n.on_decode([], 0.0, 0.0) is None
    assert n.some_hook_added_next_year(1, 2, kw=3) is None
    assert n.on_tokens is n.poll_jit
    with pytest.raises(AttributeError):
        n.__html__
    with pytest.raises(AttributeError):
        n.x = 1


def test_logger_levels(monkeypatch, capsys):
    monkeypatch.delenv("REPRO_LOG", raising=False)
    log("serve", "hello")
    log("serve", "noise", level="debug")
    assert capsys.readouterr().out == "[serve] hello\n"
    assert log_enabled("info") and not log_enabled("debug")
    monkeypatch.setenv("REPRO_LOG", "debug")
    log("spec", "detail", level="debug")
    assert capsys.readouterr().out == "[spec] detail\n"
    monkeypatch.setenv("REPRO_LOG", "quiet")
    log("serve", "hidden")
    assert capsys.readouterr().out == ""
    assert not log_enabled("info")


def test_jit_site_without_build_count_degrades():
    rec = Recorder(trace=False)
    rec.register_jit_site("weird.site", lambda x: x)
    rec.poll_jit()
    rec.reset()
    rec.poll_jit()
    assert rec.registry.sum_values("jit_cache_misses_total") == 0
    assert rec.registry.find("jit_cache_misses_total") == []


def test_summary_table_deterministic_order():
    def build(reverse):
        r = MetricsRegistry()
        items = [("z_custom_total", {"a": "1"}), ("a_custom_total", {}),
                 ("m_custom_total", {"b": "2"}), ("m_custom_total", {"b": "1"})]
        for name, labels in (reversed(items) if reverse else items):
            r.counter(name, "", **labels).inc(2)
        r.histogram("q_hist", "", buckets=(1.0,)).observe(0.5)
        return summary_table(r)

    assert build(False) == build(True)
    t = build(False)
    assert (t.index("a_custom_total") < t.index('m_custom_total{b="1"}')
            < t.index('m_custom_total{b="2"}') < t.index("z_custom_total"))
    assert "q_hist" in t and "── serving metrics" in t


def test_slo_tracker_window_budgets_and_crossings():
    r = MetricsRegistry()
    th = SloThresholds(ttft_p99_s=0.1, tpot_p99_s=1.0, min_tok_s=1.0,
                       min_acceptance=0.5, budget_target=0.9)
    slo = SloTracker(r, clock=lambda: 100.0, window_s=30.0, thresholds=th)
    slo.note_tokens(85.0, 30)
    slo.note_tokens(95.0, 30)
    slo.note_ttft(90.0, 0.05)
    slo.note_ttft(95.0, 0.2)
    slo.note_tpot(95.0, 0.01)
    slo.note_acceptance(95.0, proposed=10, accepted=3)
    s = slo.snapshot(now=100.0)
    assert s["tok_s"] == pytest.approx(60 / 15)
    assert s["ttft_p99_s"] == 0.2 and s["ttft_samples"] == 2
    assert s["acceptance"] == pytest.approx(0.3)
    assert s["error_budget_remaining"] == {"ttft": 0.0, "tpot": 1.0,
                                           "tok_s": 1.0, "acceptance": 0.0}
    assert s["violating"] == ["acceptance", "ttft"]
    assert r.value("slo_violations_total", slo="ttft") == 1
    slo.snapshot(now=100.0)
    assert r.value("slo_violations_total", slo="ttft") == 1
    assert r.value("slo_window_tok_s") == pytest.approx(4.0)
    slo.note_ttft(140.0, 0.01)
    s2 = slo.snapshot(now=141.0)
    assert s2["ttft_samples"] == 1 and "ttft" not in s2["violating"]
    slo.note_ttft(142.0, 0.5)
    slo.snapshot(now=143.0)
    assert r.value("slo_violations_total", slo="ttft") == 2
    s3 = slo.snapshot(now=500.0)
    assert s3["tok_s"] == 0.0 and s3["error_budget_remaining"]["ttft"] == 1.0
    slo.reset()
    assert slo.snapshot(now=500.0)["violating"] == []
    text = slo_report(slo)
    assert "── slo health" in text and "none" in text


def test_request_id_trace_instant():
    rec = Recorder()
    rec.on_request_id(_Req(3), "abc-123")
    inst = [e for e in rec.to_chrome()["traceEvents"] if e["ph"] == "i"]
    assert any(e["name"] == "x-request-id" and e["args"]["id"] == "abc-123"
               and e["tid"] == 4 for e in inst)
    with pytest.raises(RuntimeError, match="trace=False"):
        Recorder(trace=False).to_chrome()


# ---------------------------------------------------------------------------
# Engines: recorder, profiler and probe on vs off, and vs the JAX engine.
# ---------------------------------------------------------------------------


def _sampled(i):
    if i % 3 == 2:
        return None  # greedy rows among sampled ones
    return SamplingParams(temperature=0.9, top_k=8 * (i % 2), top_p=0.9,
                          seed=7 + i)


def _jax_sampled(i):
    from repro.serving.sampling import SamplingParams as JSamplingParams
    s = _sampled(i)
    return None if s is None else JSamplingParams(**dataclasses.asdict(s))


def _serve(eng, prompts, sampling=None, max_new=8):
    reqs = [eng.submit(p, sampling(i) if sampling else None,
                       max_new_tokens=max_new) for i, p in enumerate(prompts)]
    steps = 0
    while eng.has_work:
        eng.step()
        steps += 1
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs], steps


def _attach(rec, profiler_cls, probe_cls, dense):
    rec.profiler = profiler_cls(rec.registry, tracer=rec.tracer, every=2)
    rec.quality = probe_cls(rec.registry, rate=1.0, dense_params=dense)
    return rec


def _samples(text):
    """``{sample: value}`` of an exposition, without what reads a clock or
    is not compared (see the module docstring)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        name = re.split(r"[{ ]", key, maxsplit=1)[0]
        if re.search(r"_seconds_(bucket|sum)$", name):
            continue
        if name in ("kernel_flops", "kernel_bytes"):
            continue
        if key == 'jit_cache_misses_total{site="sampling.sample_tokens"}':
            continue
        out[key] = value
    return out


_CASES = {
    "plain-evict": dict(spec=False, prompts=PROMPTS, sampling=False),
    "plain-evict-sampled": dict(spec=False, prompts=PROMPTS, sampling=True),
    "plain-prefix": dict(spec=False, prompts=PREFIX_PROMPTS, sampling=False,
                         knobs=dict(num_pages=None)),
    "spec-identical-f32kv": dict(spec="identical", prompts=PROMPTS),
    "spec-garbage-f32kv": dict(spec="garbage", prompts=PREFIX_PROMPTS),
    "spec-garbage-int8kv": dict(spec="garbage", prompts=PROMPTS, int8=True),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_engine_metrics_equal_jax_and_streams_unchanged(setup, case):
    c = _CASES[case]
    spec = c.get("spec")
    sampling = (_sampled, _jax_sampled) if c.get("sampling") else (None, None)
    if c.get("int8"):
        cfg = _tiny_cfg(int8_kv=True)
        tcfg = config_from_jax(cfg)
    else:
        cfg, tcfg = setup["cfg"], setup["tcfg"]
    params, tparams = setup["params"], setup["tparams"]
    draft, tdraft = ((setup["garbage"], setup["tgarbage"])
                     if spec == "garbage" else (params, tparams))
    knobs = dict(SPEC_KWARGS if spec else EVICT_KWARGS, **c.get("knobs", {}))
    opts = dict(knobs, compute_dtype=torch.float32, device="cpu")

    def port(rec=None):
        if spec:
            return SpeculativeEngine(tparams, tcfg, tdraft, recorder=rec,
                                     **opts)
        return ServeEngine(tparams, tcfg, recorder=rec, **opts)

    max_new = 8 if spec else 12  # 12: the plain pool swaps a request out
    off, _ = _serve(port(), c["prompts"], sampling[0], max_new)
    rec = _attach(Recorder(), KernelProfiler, QualityProbe, tparams)
    eng = port(rec)
    on, steps = _serve(eng, c["prompts"], sampling[0], max_new)
    assert on == off

    jrec = _attach(JRecorder(), JKernelProfiler, JQualityProbe, params)
    jeng = (JSpeculativeEngine(params, cfg, draft, recorder=jrec, **knobs)
            if spec else JServeEngine(params, cfg, recorder=jrec, **knobs))
    jon, jsteps = _serve(jeng, c["prompts"], sampling[1], max_new)
    if not c.get("sampling"):
        assert on == jon
    assert steps == jsteps

    got, want = _samples(rec.to_prometheus()), _samples(jrec.to_prometheus())
    assert got == want
    v = rec.registry.value
    assert v("kernel_profiled_steps_total") == steps // 2
    for site in ("serve.decode", "serve.prefill"):
        assert (v("jit_cache_misses_total", site=site)
                == jrec.registry.value("jit_cache_misses_total", site=site))
    assert v("serve_requests_finished_total") == len(c["prompts"])
    assert v("quality_probe_skipped_total", reason="no_amm") == len(
        c["prompts"])
    assert validate_prometheus(rec.to_prometheus()) == []
    assert validate_chrome_trace(rec.to_chrome()) == []
    if spec:
        st = eng.stats
        assert (v("spec_request_rounds_total"), v("spec_proposed_total"),
                v("spec_accepted_total"), v("spec_emitted_total")) == (
            st["rounds"], st["proposed"], st["accepted"], st["emitted"])
        assert (v("spec_rounds_total", path="greedy")
                + v("spec_rounds_total", path="sampled")
                == st["decode_calls"])
        assert eng.acceptance_rate == jeng.acceptance_rate
        if spec == "identical":
            assert eng.acceptance_rate == 1.0
        else:
            assert v("spec_corrections_total") > 0
            assert v("serve_pages_rollback_total") > 0
    else:
        assert v("serve_generated_tokens_total") == sum(map(len, on))
        if case == "plain-prefix":
            assert v("serve_cow_clones_total") > 0
            assert v("serve_prefix_reused_tokens_total") > 0
        else:
            assert v("serve_evicted_total", kind="swap") > 0
            assert v("serve_evicted_total", kind="restart") > 0
            assert rec.registry.sum_values("serve_swap_bytes_total") > 0
        if c.get("sampling"):
            assert v("jit_cache_misses_total",
                     site="sampling.sample_tokens") == 2


def test_engines_default_to_null_recorder(setup):
    opts = dict(max_batch=1, max_len=64, compute_dtype=torch.float32,
                device="cpu")
    assert ServeEngine(setup["tparams"], setup["tcfg"], **opts).obs is \
        NULL_RECORDER
    # the port's speculative engine keeps its counters in ``stats``, so it
    # needs no recorder (the JAX one defaults to a metrics-only Recorder)
    spec = SpeculativeEngine(setup["tparams"], setup["tcfg"],
                             setup["tparams"], **opts)
    assert spec.obs is NULL_RECORDER and spec.kv_draft.obs is NULL_RECORDER


def test_trace_schema_from_engine_run(setup):
    rec = Recorder()
    eng = ServeEngine(setup["tparams"], setup["tcfg"], recorder=rec,
                      compute_dtype=torch.float32, device="cpu",
                      **EVICT_KWARGS)
    _serve(eng, PROMPTS)
    obj = rec.to_chrome()
    assert validate_chrome_trace(obj) == []
    assert validate_chrome_trace(json.loads(json.dumps(obj))) == []
    events = obj["traceEvents"]
    lanes = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert "engine" in lanes
    assert {f"req {i}" for i in range(len(PROMPTS))} <= lanes
    names = {e["name"] for e in events if e["ph"] != "M"}
    assert {"queued", "prefill[0]", "decode", "finish"} <= names
    assert any(n.startswith("evict[") for n in names)
    table = summary_table(rec.registry)
    assert "TTFT" in table and "page pool" in table


def test_build_counter_and_reset(setup):
    """A cold engine builds its decode and prefill programs once (the JAX
    engine's compile-cache misses); a second workload adds none, and a
    reset re-bases the counts and feeds the SLO window afresh."""
    rec = Recorder(trace=True)
    eng = ServeEngine(setup["tparams"], setup["tcfg"], max_batch=2,
                      max_len=64, recorder=rec, compute_dtype=torch.float32,
                      device="cpu")
    _serve(eng, PROMPTS[:2], max_new=4)
    v = rec.registry.value
    assert v("jit_cache_misses_total", site="serve.decode") == 1
    assert v("jit_cache_misses_total", site="serve.prefill") == 1
    assert eng._decode.builds == eng._prefill.builds == 1
    s = rec.slo.snapshot()
    assert s["ttft_samples"] == 2 and s["tpot_samples"] == 2 and s["tok_s"] > 0
    misses = rec.registry.sum_values("jit_cache_misses_total")
    _serve(eng, PROMPTS[:2], max_new=4)
    assert rec.registry.sum_values("jit_cache_misses_total") == misses
    rec.reset()
    assert v("serve_requests_finished_total") == 0
    assert rec.registry.find("serve_ttft_seconds")[0].count == 0
    assert rec.to_chrome()["traceEvents"] == []
    assert rec.slo.snapshot()["ttft_samples"] == 0
    _serve(eng, [[1, 2, 3]], max_new=4)
    assert rec.registry.sum_values("jit_cache_misses_total") == 0
    assert v("serve_requests_finished_total") == 1


# ---------------------------------------------------------------------------
# Kernel profiler.
# ---------------------------------------------------------------------------


def test_profiler_rejects_bad_every():
    with pytest.raises(ValueError, match="every"):
        KernelProfiler(MetricsRegistry(), every=0)


@pytest.mark.parametrize("every", [1, 3])
def test_profiled_steps_and_snapshot(setup, every):
    rec = Recorder(trace=True)
    rec.profiler = KernelProfiler(rec.registry, tracer=rec.tracer,
                                  every=every)
    eng = ServeEngine(setup["tparams"], setup["tcfg"], max_batch=2,
                      max_len=64, recorder=rec, compute_dtype=torch.float32,
                      device="cpu")
    _, steps = _serve(eng, PROMPTS[:3])
    assert rec.registry.value("kernel_profiled_steps_total") == steps // every
    snap = rec.profiler.snapshot()
    assert snap["profiled_steps"] == steps // every
    assert snap["sites"]["serve.decode"]["count"] > 0
    assert snap["sites"]["serve.decode"]["flops"] > 0
    lanes = {e["args"]["name"] for e in rec.to_chrome()["traceEvents"]
             if e["ph"] == "M"}
    assert "kernels" in lanes


def test_dispatch_hook_counts_and_detaches():
    from repro_torch.kernels import dispatch as D

    rng = np.random.default_rng(0)
    c, depth, d_sub, n = 2, 2, 4, 3
    p = D.params_from_arrays(
        torch.from_numpy(rng.integers(0, d_sub, (c, depth)).astype(np.int32)),
        torch.from_numpy(rng.standard_normal((c, 2 ** depth - 1))
                         .astype(np.float32)),
        torch.from_numpy(rng.standard_normal((c, 2 ** depth, n))
                         .astype(np.float32)),
        torch.ones(n), torch.zeros(n))
    x = torch.from_numpy(rng.standard_normal((5, c * d_sub))
                         .astype(np.float32))
    r = MetricsRegistry()
    detach = attach_dispatch_hook(r)
    try:
        D.lutmu_matmul(x, p, backend="ref", input_kind="full")
        assert r.value("lutmu_dispatch_total", backend="ref",
                       input_kind="full") == 1
        with D.profile_hook_paused():
            D.lutmu_matmul(x, p, backend="ref", input_kind="full")
        assert r.value("lutmu_dispatch_total", backend="ref",
                       input_kind="full") == 1
    finally:
        detach()
    D.lutmu_matmul(x, p, backend="ref", input_kind="full")
    assert r.value("lutmu_dispatch_total", backend="ref",
                   input_kind="full") == 1


def test_dispatch_hook_counts_built_programs(setup):
    """Through an engine the hook fires on a program's building call
    only: 3 projections × 2 layers per built program, not per step."""
    amm = _tiny_cfg(int8_kv=True)
    cfg = config_from_jax(dataclasses.replace(
        amm, amm=dataclasses.replace(amm.amm, kv_int8=False)))
    from repro_torch.models.model import init_params
    tparams = init_params(cfg, torch.Generator().manual_seed(0),
                          serving=True)
    r = MetricsRegistry()
    detach = attach_dispatch_hook(r)
    try:
        eng = ServeEngine(tparams, cfg, max_batch=2, max_len=64,
                          compute_dtype=torch.float32, device="cpu")
        _serve(eng, PROMPTS[:3])
    finally:
        detach()
    built = eng._decode.builds + eng._prefill.builds
    assert built == 2
    assert r.sum_values("lutmu_dispatch_total") == 3 * cfg.num_layers * built


def test_forward_cost_hand_count(setup):
    """The tiny config (D 64, F 128, 2 layers, Hq 2, Hkv 1, hd 32, V 64),
    2 decode rows against a 64-position view, float32 KV."""
    cfg = setup["tcfg"]
    proj = 2 * 64 * 32 * (2 * 2 + 2 * 1)       # Q, K, V, O
    attn = 4 * 2 * 32 * 64                     # QK and PV over 64 positions
    mlp = 6 * 64 * 128                         # gate, up, down
    head = 2 * 64 * 64
    flops = 2 * (1 * 2 * (proj + attn + mlp) + head)
    kv = 2 * 2 * 2 * (64 + 1) * 1 * 32 * 4     # rows·layers·(k,v)·positions
    assert forward_cost(cfg, rows=2, tokens=1, ctx=64, head_tokens=1,
                        kv_itemsize=4, param_bytes=1000) == (
        flops, 1000 + kv + 2 * 64 * 4)
    # the LUT-MU MLP: the paper's online op count of gate, up and down
    amm = dataclasses.replace(cfg, amm=dataclasses.replace(cfg.amm,
                                                           enabled=True))
    c_up, c_down, depth = 64 // 8, 128 // 8, 4
    cols = depth * c_down
    lut = 2 * (c_up * depth + (c_up - 1) * cols) + (c_down * depth
                                                    + (c_down - 1) * 64)
    f, _ = forward_cost(amm, rows=1, tokens=3, ctx=16, head_tokens=1,
                        kv_itemsize=1, param_bytes=0)
    assert f == 3 * 2 * (proj + 4 * 2 * 32 * 16 + lut) + head

"""The port's ``SpeculativeEngine`` against the JAX ``SpeculativeEngine``.

The tiny config of ``tests/test_speculative.py`` (2 layers, d_model 64),
JAX params carried across with ``convert.params_from_jax`` so both engines
serve the same function.  For float32 KV and for the int8 KV cache, and
for an identical draft (``spec_k`` 1 and 3: acceptance exactly 1.0), a
garbage draft, eviction with host swap of both caches, prefix sharing with
copy-on-write, eos inside the window and cancellation: the port's greedy
streams equal the JAX engine's and the plain engine's, its ``stats`` equal
JAX's counters, the pool drains to 0 and the scheduler invariants hold.
Streams are token ids: compared exactly.

A target+draft bundle the JAX compiler writes (int8 target, int4 draft) is
read from disk by the port's ``load_engine``: its speculative streams and
``stats`` equal JAX's on the same directory, ``speculative=False`` serves
the target half, and loaded artifacts or a ``(target, draft)`` pair serve
as sources too.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.compiler import compile_lm_bundle
from repro.configs import get_config
from repro.models import model as JMD
from repro.serving import ServeEngine as JServeEngine
from repro.serving import SpeculativeEngine as JSpeculativeEngine
from repro.serving import load_engine as jax_load_engine
from repro_torch.compiler import load_bundle
from repro_torch.convert import config_from_jax, params_from_jax
from repro_torch.serving import (SamplingParams, ServeEngine,
                                 SpeculativeEngine, load_engine)

PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 2], [4, 4, 1, 1, 5, 6, 7],
           [3, 1], list(range(1, 21))]
STEM = [5, 1, 4, 1, 5, 9, 2, 6, 5, 3]
PREFIX_PROMPTS = [STEM + [7, 7, 7], STEM + [7, 7, 7], STEM + [8, 8],
                  STEM[:6] + [9, 9, 9, 9], [2, 7, 1, 8, 2, 8]]
KNOBS = dict(max_batch=3, max_len=64, page_size=16, prefill_chunk=4)
SPEC_KEYS = ("rounds", "proposed", "accepted", "emitted", "corrections",
             "bonuses")


def _tiny_cfg(int8_kv):
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


@pytest.fixture(scope="module", params=[False, True], ids=["f32kv", "int8kv"])
def setup(request):
    cfg = _tiny_cfg(request.param)
    init = jax.jit(lambda k: JMD.init_params(cfg, k))
    params, garbage = init(jax.random.PRNGKey(0)), init(jax.random.PRNGKey(99))
    plain = ServeEngine(_to_port(params), config_from_jax(cfg), device="cpu",
                        **KNOBS)
    reqs = [plain.submit(p, max_new_tokens=8) for p in PROMPTS]
    plain.run_until_drained()
    oracle = {tuple(r.prompt): list(r.generated) for r in reqs}
    return dict(cfg=cfg, tcfg=config_from_jax(cfg), params=params,
                garbage=garbage, tparams=_to_port(params),
                tgarbage=_to_port(garbage), oracle=oracle,
                int8=request.param)


def _engines(st, draft, **kw):
    jd, td = ((st["params"], st["tparams"]) if draft == "identical"
              else (st["garbage"], st["tgarbage"]))
    opts = {**KNOBS, **kw}
    jeng = JSpeculativeEngine(st["params"], st["cfg"], jd, **opts)
    teng = SpeculativeEngine(st["tparams"], st["tcfg"], td, device="cpu",
                             **opts)
    return jeng, teng


def _drain(eng, prompts, max_new=8, **submit):
    reqs = [eng.submit(p, max_new_tokens=max_new, **submit) for p in prompts]
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs]


def _check_pool(eng):
    eng.sched.check_invariants()
    eng.sched.prefix.clear()  # only the prefix index may hold pages now
    assert eng.kv.allocator.in_use == 0
    assert not eng._draft_host


def _same_counters(teng, jeng):
    assert {k: teng.stats[k] for k in SPEC_KEYS} == jeng.stats
    assert teng.acceptance_rate == jeng.acceptance_rate
    assert teng.mean_emitted_per_round == jeng.mean_emitted_per_round


@pytest.mark.parametrize("draft,spec_k,extra,max_new", [
    ("identical", 1, {}, 8),
    ("identical", 3, {}, 8),
    ("garbage", 3, {}, 8),
    # a pool too small for every request at once: eviction with host swap
    # of both caches, interleaved with rollback
    ("identical", 3, dict(page_size=4, num_pages=10), 20),
], ids=["identical-k1", "identical-k3", "garbage-k3", "eviction-k3"])
def test_port_spec_streams_and_stats_equal_jax(setup, draft, spec_k, extra,
                                               max_new):
    jeng, teng = _engines(setup, draft, spec_k=spec_k, **extra)
    swaps = []
    gather = teng.kv_draft.gather_host
    teng.kv_draft.gather_host = lambda pages: swaps.append(pages) or gather(pages)
    want = _drain(jeng, PROMPTS, max_new)
    got = _drain(teng, PROMPTS, max_new)
    assert got == want
    if max_new == 8:
        oracle = [setup["oracle"][tuple(p)] for p in PROMPTS]
    else:
        oracle = _drain(ServeEngine(setup["tparams"], setup["tcfg"],
                                    device="cpu", **KNOBS), PROMPTS, max_new)
    assert got == oracle
    _same_counters(teng, jeng)
    assert teng.stats["emitted"] == (teng.stats["accepted"]
                                     + teng.stats["corrections"]
                                     + teng.stats["bonuses"])
    if draft == "identical":
        assert teng.acceptance_rate == 1.0 and teng.stats["proposed"] > 0
    else:
        assert teng.acceptance_rate < 0.5
    if "num_pages" in extra:
        assert swaps, "the tight pool never swapped a request out"
    assert teng.kv.buffers["k"].dtype == (torch.int8 if setup["int8"]
                                          else torch.float32)
    _check_pool(teng)


def test_port_spec_shared_prefix_cow_equals_jax(setup):
    """Admissions reusing cached prefix pages, with the copy-on-write clone
    covering both caches, give the JAX engine's streams and the cold
    engine's."""
    opts = dict(spec_k=3, max_batch=2, page_size=4)
    jeng, teng = _engines(setup, "identical", **opts)
    clones = []
    clone = teng._clone_pages
    teng._clone_pages = lambda s, d: clones.append((s, d)) or clone(s, d)
    want, got = _drain(jeng, PREFIX_PROMPTS), _drain(teng, PREFIX_PROMPTS)
    assert got == want
    assert clones, "no copy-on-write clone ran"
    _same_counters(teng, jeng)
    assert teng.acceptance_rate == 1.0
    _check_pool(teng)
    _, cold = _engines(setup, "identical", prefix_cache=False, **opts)
    assert _drain(cold, PREFIX_PROMPTS) == got


def test_port_spec_eos_inside_window_equals_jax(setup):
    stream = setup["oracle"][(1, 2, 3)]
    eos = stream[2]
    jeng, teng = _engines(setup, "identical", spec_k=4, max_batch=1)
    want = _drain(jeng, [[1, 2, 3]], eos_id=eos)
    got = _drain(teng, [[1, 2, 3]], eos_id=eos)
    assert got == want == [stream[:3]]
    _same_counters(teng, jeng)
    _check_pool(teng)


def test_port_spec_cancellation_equals_jax(setup):
    results = []
    for eng in _engines(setup, "identical", spec_k=3, max_batch=1):
        a = eng.submit([1, 2, 3], max_new_tokens=6)
        b = eng.submit([7, 5], max_new_tokens=8)   # waits behind a
        c = eng.submit([9, 9, 9, 2], max_new_tokens=6)
        assert eng.cancel(c.uid)                   # cancel while queued
        eng.step()
        assert eng.cancel(a.uid)                   # cancel while active
        eng.run_until_drained()
        assert a.cancelled and c.cancelled and not b.cancelled
        assert not eng.cancel(b.uid)
        results.append((list(a.generated), list(b.generated), eng))
    (ja, jb, jeng), (ta, tb, teng) = results
    assert (ta, tb) == (ja, jb) and tb == setup["oracle"][(7, 5)]
    _same_counters(teng, jeng)
    _check_pool(teng)


def test_port_plain_int8_engine_equals_jax():
    cfg = _tiny_cfg(True)
    params = jax.jit(lambda k: JMD.init_params(cfg, k))(jax.random.PRNGKey(0))
    jeng = JServeEngine(params, cfg, **KNOBS)
    teng = ServeEngine(_to_port(params), config_from_jax(cfg), device="cpu",
                       **KNOBS)
    assert teng.kv.buffers["k"].dtype == torch.int8
    assert _drain(teng, PROMPTS) == _drain(jeng, PROMPTS)


def test_guards(setup):
    st = setup
    eng = SpeculativeEngine(st["tparams"], st["tcfg"], st["tparams"],
                            spec_k=2, device="cpu", **KNOBS)
    # sampled requests are served (ROADMAP A8): through the sampled round
    sampled = eng.submit([1, 2], SamplingParams(temperature=0.7, seed=9),
                         max_new_tokens=5)
    eng.run_until_drained()
    assert sampled.done and len(sampled.generated) == 5
    assert eng.stats["decode_calls"] > 0
    other = dataclasses.replace(st["tcfg"], num_kv_heads=2)
    with pytest.raises(ValueError, match="geometry mismatch on 'num_kv_heads'"):
        SpeculativeEngine(st["tparams"], st["tcfg"], st["tparams"],
                          draft_cfg=other, device="cpu", **KNOBS)
    with pytest.raises(ValueError, match="spec_k"):
        SpeculativeEngine(st["tparams"], st["tcfg"], st["tparams"], spec_k=0,
                          device="cpu", **KNOBS)
    with pytest.raises(ValueError, match="verify backend"):
        SpeculativeEngine(st["tparams"], st["tcfg"], st["tparams"],
                          verify_backend="nope", device="cpu", **KNOBS)
    with pytest.raises(ValueError, match="needs a bundle path or an artifact "
                       "pair"):
        load_engine(None, st["tparams"], st["tcfg"], speculative=True)
    assert eng.sched.lookahead == 3
    assert eng.kv_draft.allocator is eng.kv.allocator


@pytest.mark.parametrize("backend", ["scan", "fused"])
def test_port_spec_verify_backends_equal_plain(setup, backend):
    """Both port verify backends keep the plain engine's streams through
    the whole engine (``auto`` resolves to ``fused``)."""
    st = setup
    eng = SpeculativeEngine(st["tparams"], st["tcfg"], st["tgarbage"],
                            spec_k=3, verify_backend=backend, device="cpu",
                            **KNOBS)
    assert eng.verify_backend == backend
    assert _drain(eng, PROMPTS) == [st["oracle"][tuple(p)] for p in PROMPTS]
    _check_pool(eng)


# ---------------------------------------------------------------------------
# a compiled bundle from disk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A JAX-compiled int8 target + int4 draft bundle of the tiny config
    (spec_k 3 recorded), with the dense params both halves splice into."""
    cfg = _tiny_cfg(False)
    params = jax.jit(lambda k: JMD.init_params(cfg, k))(jax.random.PRNGKey(0))
    calib = np.random.default_rng(0).integers(0, 64, (4, 16))
    path = tmp_path_factory.mktemp("torch_spec_bundle") / "bundle"
    compile_lm_bundle(params, cfg, calib, target_resolution="int8",
                      draft_resolution="int4", spec_k=3, out=str(path))
    return dict(path=path, cfg=cfg, params=params, tparams=_to_port(params),
                tcfg=config_from_jax(cfg))


def _port_bundle_engine(bd, source=None, **kw):
    return load_engine(bd["path"] if source is None else source,
                       bd["tparams"], bd["tcfg"], device="cpu",
                       **{**KNOBS, **kw})


def test_port_serves_jax_bundle_streams_and_stats_equal_jax(bundle):
    jeng = jax_load_engine(bundle["path"], bundle["params"], bundle["cfg"],
                           **KNOBS)
    teng = _port_bundle_engine(bundle)
    assert type(teng) is SpeculativeEngine and teng.spec_k == jeng.spec_k == 3
    assert teng.draft_params["layers"]["amm_mlp"]["lut_gate"].dtype == torch.int8
    want, got = _drain(jeng, PROMPTS), _drain(teng, PROMPTS)
    assert got == want
    _same_counters(teng, jeng)
    assert 0 < teng.stats["accepted"] < teng.stats["proposed"]
    _check_pool(teng)


def test_port_bundle_target_half_and_other_sources(bundle):
    """``speculative=False`` is the target half through the plain engine;
    a loaded (target, draft) pair and ``spec_k`` given explicitly serve
    the same greedy streams."""
    want = _drain(jax_load_engine(bundle["path"], bundle["params"],
                                  bundle["cfg"], speculative=False, **KNOBS),
                  PROMPTS)
    plain = _port_bundle_engine(bundle, speculative=False)
    assert type(plain) is ServeEngine
    assert _drain(plain, PROMPTS) == want
    target, draft, manifest = load_bundle(bundle["path"])
    assert manifest["spec_k"] == 3
    pair = _port_bundle_engine(bundle, (target, draft), spec_k=2)
    assert type(pair) is SpeculativeEngine and pair.spec_k == 2
    assert _drain(pair, PROMPTS) == want
    half = _port_bundle_engine(bundle, (target, draft), speculative=False)
    assert type(half) is ServeEngine
    assert _drain(half, PROMPTS) == want
    assert _drain(_port_bundle_engine(bundle, target), PROMPTS) == want

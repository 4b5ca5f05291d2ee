"""Sampled serving: the port's ``ServeEngine`` and ``SpeculativeEngine``
against the live JAX engines on the golden reduced geometry (2 layers,
d_model 64, vocab 64), float32 compute, float KV and int8 KV, JAX params
carried across.

Each engine serves one batch of mixed requests: T = 0.8 under every
(top_k, top_p) in {0, 8} × {1.0, 0.9}, 16 seeds, and two greedy requests
among them.  The port's streams must equal JAX's, and its speculative
counters too.  The one divergence admitted is the one two float paths
cannot avoid: at a stream's first differing token the test takes the
port's own distributions there and the uniforms both packages share (the
threefry streams are bit-equal, ``tests/test_torch_sampling.py``), and the
stream passes only if some decision of that token sat within ``_tol(δ)``
of its boundary — an inverse-CDF draw within that of a cumulative-mass
boundary, or an accept test ``u·q(x)`` within that of ``p(x)`` — where
``δ`` is the largest logit difference measured between the two plain
engines at the same ``(seed, t)``.  It then stops comparing that stream.

Also: a request's stream is the same alone and in a batch of 4, on both
engines; and the port's sampled speculative streams (identical and garbage
draft) are distributed as its plain sampled streams, position by position
(``tests/dist_check.py``'s chi-squared test, pinned seeds, 200 streams ×
4 tokens).
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JMD
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServeEngine as JServeEngine
from repro.serving import SpeculativeEngine as JSpeculativeEngine
from repro.serving import sampling as JS
from repro_torch.convert import config_from_jax, params_from_jax
from repro_torch.serving import SamplingParams, ServeEngine, SpeculativeEngine
from repro_torch.serving import sampling as S
from tests.dist_check import ALPHA, compare_streams

PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 2], [4, 4, 1, 1, 5, 6, 7]]
FILTERS = [(0, 1.0), (8, 1.0), (0, 0.9), (8, 0.9)]
TEMP = 0.8
MAX_NEW = 8
KNOBS = dict(max_batch=3, max_len=64, page_size=16, prefill_chunk=4)
SPEC_K = 3
SPEC_KEYS = ("rounds", "proposed", "accepted", "emitted", "corrections",
             "bonuses")
# float32 rounding of a cumulative mass of ≤ 64 terms, beside the logit
# difference's share
MASS_ULPS = 64 * 2.0 ** -23


def _tol(delta: float) -> float:
    """How far a decision's boundary can move when every logit moves by at
    most ``delta``: each probability by a factor within exp(±2δ/T), so a
    mass or p(x), q(x) ≤ 1 by at most exp(2δ/T) - 1 each; twice that for
    a comparison of two of them, plus rounding."""
    return 2 * math.expm1(2 * delta / TEMP) + MASS_ULPS


def _requests():
    """(prompt, (temperature, top_k, top_p, seed)) of the mixed batch."""
    reqs = [(p, (TEMP, k, tp, 1000 * f + 17 * i + 3))
            for f, (k, tp) in enumerate(FILTERS)
            for i, p in enumerate(PROMPTS)]
    return reqs + [(PROMPTS[0], (0.0, 0, 1.0, 0)),
                   (PROMPTS[1], (0.0, 8, 0.9, 5))]


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


def _setup(int8_kv):
    cfg = _tiny_cfg(int8_kv)
    init = jax.jit(lambda k: JMD.init_params(cfg, k))
    params, garbage = init(jax.random.PRNGKey(0)), init(jax.random.PRNGKey(99))
    return dict(cfg=cfg, tcfg=config_from_jax(cfg), params=params,
                tparams=_to_port(params), tgarbage=_to_port(garbage))


@pytest.fixture(scope="module", params=[False, True], ids=["f32kv", "int8kv"])
def setup(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def f32kv():
    return _setup(False)


def _drain(eng, reqs, make_params, max_new=MAX_NEW):
    hs = [eng.submit(list(p), make_params(*sp), max_new_tokens=max_new)
          for p, sp in reqs]
    eng.run_until_drained()
    assert all(h.done for h in hs)
    return [list(h.generated) for h in hs]


def _record(calls):
    """(seed, t) → float32 logits row, from recorded sampler calls of rows
    with T > 0."""
    out = {}
    for logits, seed, t, temp in calls:
        for r in np.nonzero(temp > 0)[0]:
            out[(int(seed[r]), int(t[r]))] = logits[r]
    return out


def _port_spy(monkeypatch, calls):
    orig = S.sample_tokens

    def spy(logits, seed, t, temperature, top_k, top_p):
        calls.append((logits.numpy().copy(), seed.numpy() & 0xFFFFFFFF,
                      t.numpy().copy(), temperature.numpy().copy()))
        return orig(logits, seed, t, temperature, top_k, top_p)

    monkeypatch.setattr(S, "sample_tokens", spy)


def _jax_spy(monkeypatch, calls):
    orig = JS.sample_tokens_jit

    def spy(logits, seed, t, temp, top_k, top_p):
        calls.append((np.asarray(logits), np.asarray(seed, np.int64),
                      np.asarray(t), np.asarray(temp)))
        return orig(logits, seed, t, temp, top_k, top_p)

    monkeypatch.setattr(JS, "sample_tokens_jit", spy)


def _cdf_gap(probs: torch.Tensor, u: torch.Tensor) -> float:
    """Distance of ``u · total`` from the nearest cumulative-mass boundary
    of ``probs (V,)``."""
    csum = torch.cumsum(probs.double(), 0)
    x = float(u) * float(csum[-1])
    return float((csum - x).abs().min().clamp(max=x))


def _first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _plain_gap(logits, seed, t, top_k, top_p) -> float:
    probs = S.sampling_probs(torch.from_numpy(logits)[None], TEMP,
                             torch.tensor(top_k), torch.tensor(top_p))[0]
    return _cdf_gap(probs, S.stream_uniform(seed, t, S.ROLE_SAMPLE))


def _round_gaps(rec, row, upto) -> float:
    """The smallest decision gap of one recorded round's ``row`` at window
    positions ``0..upto``: the draft's and the residual's inverse-CDF
    draws, the accept tests and the bonus draw."""
    p, q, draft, seed, t0, n_valid, (u_acc, u_res, u_bonus) = rec
    k = q.shape[1]
    u_draft = S.stream_uniform(seed[row], t0[row] + torch.arange(k),
                               S.ROLE_DRAFT)
    nv = int(n_valid[row])
    gaps = []
    for j in range(min(upto + 1, k)):
        x = int(draft[row, j])
        gaps.append(_cdf_gap(q[row, j], u_draft[j]))
        if j < nv - 1:
            gaps.append(abs(float(u_acc[row, j]) * float(q[row, j, x])
                            - float(p[row, j, x])))
            gaps.append(_cdf_gap(torch.clamp(p[row, j] - q[row, j], min=0),
                                 u_res[row, j]))
    if upto >= nv - 1:
        gaps.append(_cdf_gap(p[row, max(nv - 1, 0)], u_bonus[row]))
    return min(gaps)


def test_sampled_streams_equal_live_jax(setup, monkeypatch):
    reqs = _requests()
    jcalls, tcalls, rounds = [], [], []
    _jax_spy(monkeypatch, jcalls)
    _port_spy(monkeypatch, tcalls)
    orig_accept = S.speculative_accept

    def accept_spy(p, q, draft, seed, t0, n_valid, uniforms=None):
        rounds.append((p, q, draft, seed, t0, n_valid, uniforms))
        return orig_accept(p, q, draft, seed, t0, n_valid, uniforms=uniforms)

    monkeypatch.setattr(S, "speculative_accept", accept_spy)
    want = _drain(JServeEngine(setup["params"], setup["cfg"], **KNOBS), reqs,
                  JSamplingParams)
    got = _drain(ServeEngine(setup["tparams"], setup["tcfg"], device="cpu",
                             **KNOBS), reqs, SamplingParams)
    assert all(len(s) == MAX_NEW for s in got)
    jrec, trec = _record(jcalls), _record(tcalls)
    shared = trec.keys() & jrec.keys()
    assert len(shared) >= 16 * MAX_NEW // 2
    delta = max(float(np.abs(trec[k] - jrec[k]).max()) for k in shared)
    tol = _tol(delta)
    diverged = 0
    for (prompt, (temp, top_k, top_p, seed)), a, b in zip(reqs, got, want):
        at = _first_diff(a, b)
        if at is None:
            continue
        assert temp > 0, f"greedy stream {prompt} differs from JAX's at {at}"
        diverged += 1
        gap = _plain_gap(trec[(seed, at)], seed, at, top_k, top_p)
        assert gap <= tol, (f"seed {seed}: first difference at {at} with its "
                            f"draw {gap:.3g} from a boundary > {tol:.3g} "
                            f"(logit difference {delta:.3g})")
    assert diverged <= len(reqs) // 4, f"{diverged} streams diverged"

    jeng = JSpeculativeEngine(setup["params"], setup["cfg"], setup["params"],
                              spec_k=SPEC_K, **KNOBS)
    teng = SpeculativeEngine(setup["tparams"], setup["tcfg"],
                             setup["tparams"], spec_k=SPEC_K, device="cpu",
                             **KNOBS)
    want = _drain(jeng, reqs, JSamplingParams)
    got = _drain(teng, reqs, SamplingParams)
    assert rounds, "the sampled round never ran"
    diverged = 0
    for (prompt, (temp, _, _, seed)), a, b in zip(reqs, got, want):
        at = _first_diff(a, b)
        if at is None:
            continue
        assert temp > 0, f"greedy stream {prompt} differs from JAX's at {at}"
        diverged += 1
        hits = [(rec, r) for rec in rounds
                for r in np.nonzero(rec[5].numpy() > 0)[0]
                if int(rec[3][r]) == seed
                and int(rec[4][r]) <= at < int(rec[4][r]) + int(rec[5][r])]
        assert len(hits) == 1, f"seed {seed}: no round emitted index {at}"
        (rec, r), = hits
        gap = _round_gaps(rec, r, at - int(rec[4][r]))
        assert gap <= tol, (f"speculative seed {seed}: first difference at "
                            f"{at} with every decision {gap:.3g} or more from "
                            f"its boundary > {tol:.3g}")
    assert diverged <= len(reqs) // 4, f"{diverged} streams diverged"
    if diverged == 0:
        assert {k: teng.stats[k] for k in SPEC_KEYS} == jeng.stats
    assert teng.acceptance_rate == 1.0 or diverged > 0  # identical draft


@pytest.mark.parametrize("engine", ["plain", "speculative"])
def test_stream_is_the_same_alone_and_in_a_batch(setup, engine):
    def make():
        if engine == "plain":
            return ServeEngine(setup["tparams"], setup["tcfg"], device="cpu",
                               **KNOBS)
        return SpeculativeEngine(setup["tparams"], setup["tcfg"],
                                 setup["tgarbage"], spec_k=SPEC_K,
                                 device="cpu", **KNOBS)

    mine = (PROMPTS[2], (TEMP, 8, 0.9, 4242))
    others = [(PROMPTS[0], (1.0, 0, 1.0, 7)), (PROMPTS[3], (0.0, 0, 1.0, 0)),
              (PROMPTS[1], (0.5, 3, 0.8, 4242))]
    alone = _drain(make(), [mine], SamplingParams, max_new=12)[0]
    batched = _drain(make(), [others[0], mine] + others[1:], SamplingParams,
                     max_new=12)
    assert batched[1] == alone
    assert _drain(make(), [mine], SamplingParams, max_new=12)[0] == alone
    assert len(set(map(tuple, batched))) == len(batched)


DIST_N, DIST_NEW, DIST_PROMPT = 200, 4, [3, 1, 4, 1]
DIST_BASE = SamplingParams(temperature=1.0, top_k=0, top_p=1.0)
DIST_OPTS = dict(KNOBS, max_batch=8)


def _dist_streams(eng):
    """DIST_N streams of DIST_PROMPT, stream ``i`` seeded 5000 + i."""
    hs = [eng.submit(DIST_PROMPT, dataclasses.replace(DIST_BASE, seed=5000 + i),
                     max_new_tokens=DIST_NEW) for i in range(DIST_N)]
    eng.run_until_drained()
    return np.array([h.generated for h in hs], np.int64)


@pytest.fixture(scope="module")
def plain_dist(f32kv):
    return _dist_streams(ServeEngine(f32kv["tparams"], f32kv["tcfg"],
                                     device="cpu", **DIST_OPTS))


@pytest.mark.parametrize("draft", ["identical", "garbage"])
def test_spec_sampled_streams_distributed_as_plain(f32kv, plain_dist, draft):
    dparams = f32kv["tparams" if draft == "identical" else "tgarbage"]
    eng = SpeculativeEngine(f32kv["tparams"], f32kv["tcfg"], dparams,
                            spec_k=SPEC_K, device="cpu", **DIST_OPTS)
    spec = _dist_streams(eng)
    if draft == "garbage":
        assert eng.stats["corrections"] > 0 and eng.acceptance_rate < 0.9
    else:
        assert eng.acceptance_rate == 1.0
    assert not np.array_equal(spec, plain_dist)  # other draws, same law
    results = compare_streams(plain_dist, spec, f32kv["cfg"].vocab_size)
    for t, (p_value, groups) in enumerate(results):
        assert groups >= 2, f"position {t}: one category"
        assert p_value > ALPHA, (f"position {t}: speculative vs plain "
                                 f"p = {p_value:.2e} ({groups} groups)")

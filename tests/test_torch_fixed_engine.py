"""The port's ``FixedSlotEngine`` against the JAX ``FixedSlotEngine``, its
paged ``ServeEngine`` against its own fixed engine, and the paged engine's
MoE streams against the JAX ``ServeEngine``'s, on the CPU at float32, both
packages holding the same params (and loading the same ``amm_lm``
artifact).

Each fixed-engine case serves one batch through both packages' engines in
lockstep: 5 requests into 2 slots (staggered admission), greedy and sampled
(T 0.8 with top-k or top-p), one that runs into ``max_len``, one that stops
at its eos token, one cancelled in the queue and one cancelled while
active.  The cases: the golden setup's dense model, its ``amm_lm``
artifact compiled live (int8 LUTs; the checked-in golden streams are
stale, ROADMAP C1) served with ``engine="fixed"``, mamba2 and jamba (one
period, LUT-MU MLPs in its dense layers), reduced.

Streams must be equal.  The one divergence admitted is the one two float
paths cannot avoid: at a stream's first differing token, JAX's logits there
(recorded from its sampler's calls) must have a top-2 margin within
``LOGIT_TOL``, the largest logit difference the model tests allow
(``tests/test_torch_families.py``); the stream is not compared past it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JMD
from repro.serving import FixedSlotEngine as JFixedSlotEngine
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServeEngine as JServeEngine
from repro.serving import load_engine as jax_load_engine
from repro.serving import sampling as JS
from repro_torch.compiler import compile_lm_amm
from repro_torch.convert import config_from_jax, params_from_jax
from repro_torch.models import model as TMD
from repro_torch.serving import (FixedSlotEngine, SamplingParams, ServeEngine,
                                 load_engine, make_engine)

LOGIT_TOL = 1e-4
SLOTS, MAX_LEN = 2, 16
# (prompt, (temperature, top_k, top_p, seed), max_new_tokens); two prompt
# lengths, so the JAX engine compiles two prefills
REQS = [([3, 1, 2], (0.0, 0, 1.0, 11), 6),          # stops at its eos
        ([7, 5, 4], (0.8, 8, 1.0, 12), 6),          # cancelled, active
        ([9, 9, 9, 2, 1], (0.0, 0, 1.0, 13), 40),   # runs into max_len
        ([4, 4, 1, 1, 5], (0.8, 0, 0.9, 14), 6),
        ([2, 8, 6, 5, 3], (0.8, 8, 0.9, 16), 6)]    # cancelled, queued
EOS_REQ, QUEUED_CANCEL, ACTIVE_CANCEL = 0, 4, 1
# the paged-vs-fixed differential (tests/test_serving.py's prompts)
PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 2], [4, 4, 1, 1, 5, 6, 7],
           [3, 1], list(range(1, 21))]


def _golden_cfg():
    cfg = get_config("qwen3-14b", reduced=True)
    return dataclasses.replace(cfg, num_layers=2, d_model=64, d_ff=128,
                               vocab_size=64, num_heads=2, num_kv_heads=1,
                               head_dim=32)


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def _init(cfg, serving=False):
    """Params drawn by the port (no JAX compile), and the same arrays for
    JAX."""
    tparams = TMD.init_params(config_from_jax(cfg),
                              torch.Generator().manual_seed(0),
                              serving=serving)
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams), tparams


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The golden setup (``tests/test_serving_golden.py``: JAX
    ``init_params`` at ``PRNGKey(0)``, calibration tokens from numpy seed
    0): its dense params and its int8 ``amm_lm`` artifact, compiled live
    (by the port's compiler; both packages' engines load it from disk)."""
    cfg = _golden_cfg()
    params = jax.jit(lambda k: JMD.init_params(cfg, k))(jax.random.PRNGKey(0))
    tparams, tcfg = _port(params), config_from_jax(cfg)
    calib = np.random.default_rng(0).integers(0, 64, (4, 16))
    art = tmp_path_factory.mktemp("fixed_golden") / "lm_art"
    compile_lm_amm(tparams, tcfg, calib, out=str(art))
    return dict(cfg=cfg, params=params, tcfg=tcfg, tparams=tparams, art=art)


def _engines(case, golden):
    """(JAX engine, port engine) of one case, 2 slots, max_len 16."""
    if case in ("dense", "amm_lm"):
        source = golden["art"] if case == "amm_lm" else None
        return (jax_load_engine(source, golden["params"], golden["cfg"],
                                engine="fixed", max_batch=SLOTS,
                                max_len=MAX_LEN),
                load_engine(source, golden["tparams"], golden["tcfg"],
                            engine="fixed", max_batch=SLOTS, max_len=MAX_LEN,
                            compute_dtype=torch.float32, device="cpu"))
    cfg = get_config(case, reduced=True)
    if cfg.is_hybrid:  # one period, LUT-MU MLPs in the dense layers
        cfg = dataclasses.replace(cfg, num_layers=cfg.attn_every,
                                  amm=dataclasses.replace(cfg.amm,
                                                          enabled=True))
    params, tparams = _init(cfg, serving=True)
    return (JFixedSlotEngine(params, cfg, slots=SLOTS, max_len=MAX_LEN),
            FixedSlotEngine(tparams, config_from_jax(cfg), slots=SLOTS,
                            max_len=MAX_LEN, device="cpu"))


def _serve(eng, make_sampling, eos=None):
    """Submit REQS, step until drained with the two cancels at fixed steps;
    returns the requests' streams and handles."""
    hs = [eng.submit(list(p), make_sampling(*sp), max_new_tokens=n,
                     eos_id=eos if i == EOS_REQ else None)
          for i, (p, sp, n) in enumerate(REQS)]
    steps = 0
    while eng.has_work:
        eng.step()
        steps += 1
        if steps == 1:
            assert hs[QUEUED_CANCEL].cancel()
        if steps == 3:
            assert hs[ACTIVE_CANCEL].cancel()
    return [list(h.generated) for h in hs], hs


def _jax_spy(monkeypatch, rows):
    """(seed, t) → JAX's logits row, for every active row it samples."""
    orig = JS.sample_tokens_jit

    def spy(logits, seed, t, temp, top_k, top_p):
        lg, sd, tt = np.asarray(logits), np.asarray(seed), np.asarray(t)
        for r in np.nonzero(sd)[0]:
            rows[(int(sd[r]), int(tt[r]))] = lg[r]
        return orig(logits, seed, t, temp, top_k, top_p)

    monkeypatch.setattr(JS, "sample_tokens_jit", spy)


def _hold(got, want, rows):
    """Equal streams, or a first difference where JAX's top-2 margin is
    within LOGIT_TOL."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        at = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        assert at is not None, (i, g, w)  # same prefix, another length
        top = np.sort(rows[(REQS[i][1][3], at)])[-2:]
        assert top[1] - top[0] <= LOGIT_TOL, (i, at, g, w, top)


@pytest.mark.parametrize("case", ["dense", "amm_lm", "mamba2-370m",
                                  "jamba-1.5-large-398b"])
def test_fixed_streams_equal_jax(golden, monkeypatch, case):
    jeng, teng = _engines(case, golden)
    assert isinstance(teng, FixedSlotEngine) and teng.slots == SLOTS
    assert teng.cfg.amm.enabled == (case in ("amm_lm",
                                             "jamba-1.5-large-398b"))
    # the eos request's third greedy token, from a run of the port alone
    probe = FixedSlotEngine(teng.params, teng.cfg, slots=SLOTS,
                            max_len=MAX_LEN, device="cpu")
    eos = probe.submit(REQS[EOS_REQ][0], max_new_tokens=6).result()[2]
    rows = {}
    _jax_spy(monkeypatch, rows)
    want, jh = _serve(jeng, JSamplingParams, eos)
    got, th = _serve(teng, SamplingParams, eos)
    _hold(got, want, rows)
    assert [h.status for h in th] == [h.status for h in jh]
    assert th[QUEUED_CANCEL].status == "cancelled" and got[QUEUED_CANCEL] == []
    assert th[ACTIVE_CANCEL].status == "cancelled"
    # 5 prompt tokens + the prefill's token + 10 decodes: position 15
    assert len(got[2]) == MAX_LEN - len(REQS[2][0])
    assert got[EOS_REQ][-1] == eos and len(got[EOS_REQ]) <= 3
    assert len(got[3]) == 6
    assert teng.stats["prefill_calls"] == 4 and not teng.has_work


@pytest.mark.parametrize("amm", [False, True], ids=["dense", "int-lut"])
def test_paged_bitmatches_fixed_slot(golden, amm):
    """The port's paged engine (chunked prefill, 3 rows) against its own
    fixed-slot engine (whole-prompt prefill, 2 slots): the same greedy
    streams, as the JAX engines' (``tests/test_serving.py``)."""
    source = golden["art"] if amm else None
    opts = dict(max_len=64, compute_dtype=torch.float32, device="cpu")
    fixed = load_engine(source, golden["tparams"], golden["tcfg"],
                        engine="fixed", max_batch=2, **opts)
    paged = load_engine(source, golden["tparams"], golden["tcfg"],
                        max_batch=3, page_size=16, prefill_chunk=4, **opts)
    assert type(fixed) is FixedSlotEngine and type(paged) is ServeEngine
    streams = []
    for eng in (fixed, paged):
        hs = [eng.submit(p, max_new_tokens=8) for p in PROMPTS]
        eng.run_until_drained()
        assert all(h.done and len(h.generated) == 8 for h in hs)
        streams.append([h.generated for h in hs])
    assert streams[0] == streams[1]


def test_paged_moe_streams_equal_jax():
    """mixtral (reduced) through both packages' paged engines: chunked
    prefill (4-token chunks, pad rows included, as the reference routes
    them) and batched decode, greedy and sampled."""
    cfg = get_config("mixtral-8x7b", reduced=True)
    params, tparams = _init(cfg)
    knobs = dict(max_batch=2, max_len=64, page_size=16, prefill_chunk=4)
    reqs = [(p, (0.8 if i % 2 else 0.0, 8, 1.0, 21 + i))
            for i, p in enumerate(PROMPTS[:4])]
    streams = []
    for eng, sp in ((JServeEngine(params, cfg, **knobs), JSamplingParams),
                    (ServeEngine(tparams, config_from_jax(cfg),
                                 compute_dtype=torch.float32, device="cpu",
                                 **knobs), SamplingParams)):
        hs = [eng.submit(p, sp(*s), max_new_tokens=8) for p, s in reqs]
        eng.run_until_drained()
        streams.append([list(h.generated) for h in hs])
    assert streams[1] == streams[0]


def test_family_dispatch_and_paged_refusal(golden):
    """Families without a paged layout get fixed slots (``max_batch`` maps
    to ``slots``); the paged engine refuses them naming FixedSlotEngine,
    as JAX's does (``tests/test_serving.py``)."""
    ssm = get_config("mamba2-370m", reduced=True)
    tssm = config_from_jax(ssm)
    jparams, sparams = _init(ssm)
    with pytest.raises(ValueError, match="FixedSlotEngine"):
        ServeEngine(sparams, tssm, device="cpu")
    with pytest.raises(ValueError, match="FixedSlotEngine"):
        JServeEngine(jparams, ssm)
    eng = load_engine(None, sparams, tssm, max_batch=3, max_len=32,
                      page_size=4, prefill_chunk=4, device="cpu")
    assert type(eng) is FixedSlotEngine and eng.slots == 3
    with pytest.warns(DeprecationWarning, match="load_engine"):
        eng = make_engine(sparams, tssm, max_batch=8, max_len=32,
                          page_size=4, prefill_chunk=4, device="cpu")
    assert type(eng) is FixedSlotEngine and eng.slots == 8
    with pytest.warns(DeprecationWarning):
        dense = make_engine(golden["tparams"], golden["tcfg"], max_batch=2,
                            max_len=64, device="cpu")
    assert type(dense) is ServeEngine
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(list(range(32)))

"""The serving step programs (``serving/programs.py``) on the CPU.

* Prefill with ``start``/``n_valid`` as 0-d int32 tensors, as the captured
  prefill program passes them, is bitwise the int form and matches JAX's
  ``paged_prefill_chunk`` (which always takes them traced) within the
  tolerances of ``tests/test_torch_models.py``: atol 1e-5 / rtol 1e-4 on
  the logits, rtol 1e-5 / atol 1e-6 on the pages written.
* A ``StepProgram`` on the CPU copies its inputs into its buffers and
  returns the function's fresh outputs; the engine's KV buffers stay the
  same tensors across copy-on-write clones and swap-in, since its programs
  close over them.
* The launch counters' capture/replay accounting (``kernels/_build.py``),
  with a fake warm-up and capture: there are no graphs on a CPU.
* The sampled ``round`` program, its float and uint32 inputs staged as
  int32 bit views, equals ``sampled_round`` called on the same values as
  float32 and int64 tensors, call by call through a drain: outputs and
  both caches bitwise.  A program's unstaged tensor inputs pass through.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JMD
from repro_torch.configs import get_config as port_get_config
from repro_torch.convert import config_from_jax, params_from_jax
from repro_torch.kernels import _build
from repro_torch.models import model as TMD
from repro_torch.serving import (SamplingParams, ServeEngine,
                                 SpeculativeEngine)
from repro_torch.serving import sampling as S
from repro_torch.serving import speculative as SPEC
from repro_torch.serving.programs import StepProgram

CHUNK = 4


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen3-14b", reduced=True)
    cfg = dataclasses.replace(cfg, num_layers=2, d_model=64, d_ff=128,
                              vocab_size=64, num_heads=2, num_kv_heads=1,
                              head_dim=32)
    cfg = dataclasses.replace(cfg, amm=dataclasses.replace(cfg.amm,
                                                           enabled=True))
    jparams = jax.jit(lambda k: JMD.init_params(cfg, k, serving=True))(
        jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, config_from_jax(cfg), jparams, tparams


@pytest.mark.parametrize("start,n_valid", [(0, 4), (0, 1), (4, 3), (8, 4),
                                           (12, 2)])
def test_prefill_tensor_start_n_valid_equals_int_and_jax(model, start,
                                                         n_valid):
    cfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(start * 8 + n_valid)
    ps, n_pages = 4, 7  # page 6 is the trash page
    shape = (cfg.num_layers, n_pages, ps, 1, 32)
    cache = {n: rng.normal(size=shape).astype(np.float32) for n in "kv"}
    toks = np.zeros((1, CHUNK), np.int32)
    toks[0, :n_valid] = rng.integers(0, 64, n_valid)
    row = np.array([3, 1, 5, 0, 2], np.int32)
    jl, jcache = JMD.paged_prefill_chunk(
        jparams, jnp.asarray(toks), jnp.asarray(start), jnp.asarray(n_valid),
        jnp.asarray(row), {n: jnp.asarray(a) for n, a in cache.items()}, cfg,
        compute_dtype=jnp.float32)
    out = {}
    for form, (s, nv) in {"int": (start, n_valid),
                          "tensor": (torch.tensor(start, dtype=torch.int32),
                                     torch.tensor(n_valid, dtype=torch.int32))
                          }.items():
        tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
        logits = TMD.paged_prefill_chunk(
            tparams, torch.from_numpy(toks), s, nv, torch.from_numpy(row), tc,
            tcfg, compute_dtype=torch.float32)
        out[form] = logits, tc
    (li, ci), (lt, ct) = out["int"], out["tensor"]
    assert torch.equal(li, lt)
    assert all(torch.equal(ci[n], ct[n]) for n in "kv")
    np.testing.assert_allclose(lt.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    for n in "kv":  # the trash page is written in no fixed order
        np.testing.assert_allclose(ct[n][:, :-1].numpy(),
                                   np.asarray(jcache[n])[:, :-1], rtol=1e-5,
                                   atol=1e-6)


def test_step_program_on_cpu_copies_inputs_and_returns_fresh_outputs():
    seen = []

    def fn(a, s):
        seen.append((a, s))
        return a * 2 + s, a.sum()

    prog = StepProgram(fn, {"a": ((2, 3), 0), "s": ((), 7)},
                       torch.device("cpu"), name="t")
    a1 = np.arange(6, dtype=np.int32).reshape(2, 3)
    out1 = prog(a=a1, s=1)
    a1[:] = 100  # the program copied the array: this changes nothing
    out2 = prog(a=np.ones((2, 3), np.int32), s=np.int32(5))
    assert torch.equal(out1[0], torch.arange(6, dtype=torch.int32
                                             ).reshape(2, 3) * 2 + 1)
    assert int(out1[1]) == 15
    assert torch.equal(out2[0], torch.full((2, 3), 7, dtype=torch.int32))
    assert out1[0].data_ptr() != out2[0].data_ptr()
    # the function sees the program's own buffers, the same ones each call
    assert seen[0][0] is prog.inputs["a"] and seen[1][0] is prog.inputs["a"]
    assert prog.graph is None and "capture_s" not in prog.stats
    with pytest.raises(ValueError, match="shape"):
        prog(a=np.ones((3, 2), np.int32), s=1)
    with pytest.raises(ValueError, match="inputs"):
        prog(a=a1)


def _tiny_engine(cls, **kw):
    cfg = port_get_config("qwen3-14b", reduced=True)
    cfg = dataclasses.replace(cfg, num_layers=2, d_model=64, d_ff=128,
                              vocab_size=64, num_heads=2, num_kv_heads=1,
                              head_dim=32)
    params = TMD.init_params(cfg, torch.Generator().manual_seed(0))
    opts = dict(max_batch=2, max_len=64, page_size=4, prefill_chunk=4,
                device="cpu", **kw)
    if cls is SpeculativeEngine:
        return cls(params, cfg, params, spec_k=2, **opts)
    return cls(params, cfg, **opts)


STEM = [5, 1, 4, 1, 5, 9, 2, 6, 5, 3]
PROMPTS = [STEM + [7, 7, 7], STEM + [7, 7, 7], STEM + [8, 8],
           STEM[:6] + [9, 9, 9, 9], [2, 7, 1, 8, 2, 8]]


@pytest.mark.parametrize("cls", [ServeEngine, SpeculativeEngine])
def test_engine_kv_buffers_stay_the_same_tensors(cls):
    """Copy-on-write clones and swap-in write the KV buffers in place, so
    the tensors the step programs closed over stay the engine's cache;
    streams equal a cold engine's with the full pool."""
    eng = _tiny_engine(cls, num_pages=9)
    caches = [eng.kv] + ([eng.kv_draft] if cls is SpeculativeEngine else [])
    ids = [(id(c.buffers), {n: (b, b.data_ptr())
                            for n, b in c.buffers.items()}) for c in caches]
    calls = {"clone": 0, "swap_in": 0}
    clone, swap_in = eng._clone_pages, eng._swap_in

    def spy_clone(s, d):
        calls["clone"] += 1
        clone(s, d)

    def spy_swap_in(req):
        calls["swap_in"] += 1
        swap_in(req)

    eng._clone_pages, eng._swap_in = spy_clone, spy_swap_in
    reqs = [eng.submit(p, max_new_tokens=12) for p in PROMPTS]
    eng.run_until_drained()
    assert calls["clone"] > 0 and calls["swap_in"] > 0, calls
    for c, (bid, bufs) in zip(caches, ids):
        assert id(c.buffers) == bid
        for n, (b, ptr) in bufs.items():
            assert c.buffers[n] is b and b.data_ptr() == ptr
    cold = _tiny_engine(cls, prefix_cache=False)
    want = [cold.submit(p, max_new_tokens=12) for p in PROMPTS]
    cold.run_until_drained()
    assert [r.generated for r in reqs] == [r.generated for r in want]


def test_captured_launches_count_replays_not_warm_up_or_capture():
    a, b, c = _build.LaunchCount(), _build.LaunchCount(), _build.LaunchCount()
    a.n, b.n = 10, 4

    def warm_up():  # the eager run before the capture launches too
        a.bump()
        b.bump()
        c.bump()

    def capture():  # what one replay launches: a twice, c once
        a.bump()
        a.bump()
        c.bump()

    launches = _build.CapturedLaunches(warm_up, capture)
    assert (a.n, b.n, c.n) == (10, 4, 0)
    for _ in range(3):
        launches.replay()
    assert (a.n, b.n, c.n) == (16, 4, 3)

    def failed_capture():
        a.bump()
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        _build.CapturedLaunches(warm_up, failed_capture)
    assert (a.n, b.n, c.n) == (16, 4, 3)


def test_step_program_passes_tensor_inputs_through_on_cpu():
    prog = StepProgram(lambda x, a: x[:2] * a, {"a": ((2,), 0)},
                       torch.device("cpu"), name="t", tensors=("x",))
    x = torch.arange(4.0)
    assert torch.equal(prog(x=x, a=np.int32([2, 3])), torch.tensor([0., 3.]))
    assert torch.equal(prog(x=x + 1, a=np.int32([1, 1])),
                       torch.tensor([1., 2.]))
    with pytest.raises(ValueError, match="tensors"):
        prog(a=np.int32([1, 1]))


def test_round_program_equals_sampled_round_on_float_inputs():
    eng = _tiny_engine(SpeculativeEngine)
    prog, calls = eng._round, []

    def spy(**arrays):
        caches = [{n: b.clone() for n, b in c.buffers.items()}
                  for c in (eng.kv, eng.kv_draft)]
        out = prog(**arrays)
        staged = {k: torch.from_numpy(np.asarray(arrays[k]))
                  for k in ("token", "pos", "n_valid", "table")}
        seed = torch.from_numpy(arrays["seed"].view(np.uint32).astype(np.int64))
        floats = {k: torch.from_numpy(arrays[k].view(np.float32))
                  for k in ("temperature", "top_p")}
        want = SPEC.sampled_round(
            eng.params, eng.draft_params, staged["token"], staged["pos"],
            staged["n_valid"], staged["table"], seed,
            torch.from_numpy(arrays["t"]), floats["temperature"],
            torch.from_numpy(arrays["top_k"]), floats["top_p"], caches[0],
            caches[1], eng.cfg, eng.draft_cfg, eng.spec_k,
            compute_dtype=eng.cd, backend=eng.verify_backend)
        for g, w in zip(out, want):
            assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w)
        for c, w in zip((eng.kv, eng.kv_draft), caches):
            assert all(torch.equal(c.buffers[n], w[n]) for n in w)
        calls.append(arrays)
        return out

    eng._round = spy
    reqs = [eng.submit(p, SamplingParams(temperature=0.9, top_k=5 * i,
                                         top_p=1.0 - 0.1 * i,
                                         seed=2**32 - 1 - i),
                       max_new_tokens=6) for i, p in enumerate(PROMPTS[:3])]
    eng.run_until_drained()
    assert all(r.done for r in reqs) and len(calls) >= 2
    assert any((a["seed"] < 0).any() for a in calls)  # uint32 above 2^31

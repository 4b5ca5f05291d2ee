"""The port's paged ``ServeEngine`` against the JAX engine, and the port's
host-side serving pieces.

The slice gate: on the golden setup (2 layers, d_model 64, 5 prompts,
``max_new=8``, ``page_size=16``, ``prefill_chunk=4``, int8 LUTs) the JAX
compiler builds an ``amm_lm`` artifact in the test, JAX splices it, and the
spliced params are carried across; the port's greedy streams must equal the
JAX ``ServeEngine``'s streams run live in the same test (not the checked-in
JSON, which is stale under the installed JAX's PRNG mode).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.compiler import compile_lm_amm
from repro.compiler.artifact import load_artifact
from repro.configs import get_config
from repro.models import model as JMD
from repro.serving import load_engine as jax_load_engine
from repro_torch.convert import config_from_jax, params_from_jax
from repro_torch.serving import PageError, SamplingParams, load_engine

PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 2], [4, 4, 1, 1, 5, 6, 7],
           list(range(1, 18))]
MAX_NEW = 8
KNOBS = dict(max_batch=2, max_len=64, page_size=16, prefill_chunk=4)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """JAX-compiled, JAX-spliced golden-setup params and config."""
    cfg = get_config("qwen3-14b", reduced=True)
    cfg = dataclasses.replace(cfg, num_layers=2, d_model=64, d_ff=128,
                              vocab_size=64, num_heads=2, num_kv_heads=1,
                              head_dim=32)
    cfg = dataclasses.replace(cfg, amm=dataclasses.replace(cfg.amm,
                                                           enabled=True))
    params = JMD.init_params(cfg, jax.random.PRNGKey(0))
    calib = np.random.default_rng(0).integers(0, 64, (4, 16))
    out = tmp_path_factory.mktemp("torch_golden") / "lm_art"
    compile_lm_amm(params, cfg, calib, out=str(out))
    art = load_artifact(out)
    spliced = art.splice_lm_params(params)
    cfg = dataclasses.replace(cfg, amm=dataclasses.replace(
        cfg.amm, enabled=True, **art.manifest["amm"]))
    return spliced, cfg


def _port_engine(golden, **overrides):
    spliced, cfg = golden
    tparams = params_from_jax(jax.tree.map(np.asarray, spliced), device="cpu")
    opts = dict(KNOBS, compute_dtype=torch.float32, device="cpu")
    return load_engine(None, tparams, config_from_jax(cfg),
                       **{**opts, **overrides})


def _streams(engine, max_new=MAX_NEW):
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in PROMPTS]
    engine.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs]


def test_slice_gate_port_streams_equal_live_jax_streams(golden):
    spliced, cfg = golden
    want = _streams(jax_load_engine(None, spliced, cfg, **KNOBS))
    got = _streams(_port_engine(golden))
    assert all(len(s) == MAX_NEW for s in got)
    assert got == want


def test_eviction_swap_keeps_port_streams(golden):
    """A pool too small for every request at once forces page-fault
    eviction with host swap; restored pages are bit-exact, so the streams
    equal the fully provisioned engine's."""
    full = _streams(_port_engine(golden, page_size=4), max_new=20)
    tight = _port_engine(golden, page_size=4, num_pages=10, prefix_cache=False)
    swaps = []
    gather = tight.kv.gather_host
    tight.kv.gather_host = lambda pages: swaps.append(pages) or gather(pages)
    assert _streams(tight, max_new=20) == full
    assert swaps, "the tight pool never swapped a request out"


def test_engine_surface(golden):
    eng = _port_engine(golden)
    h = eng.submit([1, 2, 3], max_new_tokens=2)
    assert h.status == "queued" and h.tokens() == []
    assert len(h.result()) == 2 and h.status == "done"
    assert eng.stats["prefill_calls"] == 1 and eng.stats["decode_calls"] == 1
    c = eng.submit([4, 5], max_new_tokens=4)
    assert c.cancel() and c.status == "cancelled"
    with pytest.raises(NotImplementedError):
        eng.submit([1], SamplingParams(temperature=0.7))
    with pytest.raises(ValueError):
        eng.submit(list(range(70)))  # ≥ max_len
    with pytest.raises(NotImplementedError):
        load_engine("some/artifact", None, None)
    assert issubclass(PageError, RuntimeError)


def test_cuda_requested_without_cuda_raises(golden):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _port_engine(golden, device="cuda")

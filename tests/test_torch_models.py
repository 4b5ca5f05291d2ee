"""The port's LUT-MU MLP, paged attention and paged LM against the JAX
package, at float32 on the CPU, with JAX ``init_params(..., serving=True)``
weights carried across by ``convert.params_from_jax``.

Chained float paths are compared piece by piece on shared inputs: the
LUT-MU MLP and the attention of one layer, each fed the same numpy
activations; then the whole model's logits.  Tolerances: int8-LUT sums are
exact in both packages, so the MLP differs only by float32 rounding of the
epilogue, silu and the float32 matmuls around it (rtol 1e-5); attention and
the 2-layer model's logits compare within atol 1e-5 / rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import amm_mlp as JAMM
from repro.models import attention as JA
from repro.models import model as JMD
from repro_torch.convert import config_from_jax, params_from_jax
from repro_torch.models import amm_mlp as TAMM
from repro_torch.models import attention as TA
from repro_torch.models import model as TMD


def _golden_cfg():
    cfg = get_config("qwen3-14b", reduced=True)
    cfg = dataclasses.replace(cfg, num_layers=2, d_model=64, d_ff=128,
                              vocab_size=64, num_heads=2, num_kv_heads=1,
                              head_dim=32)
    return dataclasses.replace(cfg, amm=dataclasses.replace(cfg.amm,
                                                            enabled=True))


@pytest.fixture(scope="module")
def model():
    cfg = _golden_cfg()
    # jitted: one compile instead of op-by-op dispatch (same function; the
    # draws need not match the eager ones, both packages get these arrays)
    jparams = jax.jit(lambda k: JMD.init_params(cfg, k, serving=True))(
        jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, config_from_jax(cfg), jparams, tparams


def _layer(params, l):
    return jax.tree.map(lambda a: a[l], params)


def test_params_carry_across_exactly(model):
    _, tcfg, jparams, tparams = model
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) > 10
    for path, leaf in flat_j:
        t = tparams
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    assert tcfg.amm.enabled and tcfg.d_model == 64 and tcfg.num_layers == 2


@pytest.mark.parametrize("layer", [0, 1])
def test_amm_mlp_apply_matches_jax(model, layer):
    cfg, tcfg, jparams, tparams = model
    x = np.random.default_rng(layer).normal(size=(2, 5, 64)).astype(np.float32)
    want = JAMM.amm_mlp_apply(_layer(jparams["layers"], layer)["amm_mlp"],
                              jnp.asarray(x), cfg)
    tlayer = TMD.layer_params(tparams["layers"], layer)
    got = TAMM.amm_mlp_apply(tlayer["amm_mlp"], torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _pages(rng, n_pages, ps, nkv, hd):
    k = rng.normal(size=(n_pages, ps, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(n_pages, ps, nkv, hd)).astype(np.float32)
    return k, v


def test_paged_decode_attention_matches_jax(model):
    cfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(1)
    ps, n_pages, nkv, hd = 4, 9, 1, 32  # page 8 is the trash page
    k, v = _pages(rng, n_pages, ps, nkv, hd)
    x = rng.normal(size=(3, 1, 64)).astype(np.float32)
    table = np.array([[0, 1, 8], [2, 3, 4], [8, 8, 8]], np.int32)
    pos = np.array([5, 9, 0], np.int32)
    write_ok = np.array([True, True, False])
    for wo in (None, write_ok):
        jout, (jk, jv) = JA.paged_decode_step(
            _layer(jparams["layers"], 0)["attn"], jnp.asarray(x), cfg,
            jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
            jnp.asarray(pos), 2**30,
            write_ok=None if wo is None else jnp.asarray(wo))
        tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        tout = TA.paged_decode_step(
            TMD.layer_params(tparams["layers"], 0)["attn"],
            torch.from_numpy(x), tcfg, tk, tv, torch.from_numpy(table),
            torch.from_numpy(pos), 2**30,
            write_ok=None if wo is None else torch.from_numpy(wo))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-4,
                                   atol=1e-5)
        # pages written in place equal the JAX update (the trash page is
        # written by several rows in no fixed order; it is never read)
        np.testing.assert_allclose(tk[:8].numpy(), np.asarray(jk)[:8],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tv[:8].numpy(), np.asarray(jv)[:8],
                                   rtol=1e-5, atol=1e-6)


def test_paged_prefill_attention_matches_jax(model):
    cfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(2)
    ps, n_pages, nkv, hd = 4, 7, 1, 32
    k, v = _pages(rng, n_pages, ps, nkv, hd)
    x = rng.normal(size=(1, 6, 64)).astype(np.float32)
    row = np.array([3, 1, 5, 6], np.int32)
    start, n_valid = 4, 5
    jout, (jk, jv) = JA.paged_prefill_chunk(
        _layer(jparams["layers"], 1)["attn"], jnp.asarray(x), cfg,
        jnp.asarray(start), jnp.asarray(n_valid), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(row), 2**30)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tout = TA.paged_prefill_chunk(
        TMD.layer_params(tparams["layers"], 1)["attn"], torch.from_numpy(x),
        tcfg, start, n_valid, tk, tv, torch.from_numpy(row), 2**30)
    np.testing.assert_allclose(tout.numpy()[:, :n_valid],
                               np.asarray(jout)[:, :n_valid], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tk[:6].numpy(), np.asarray(jk)[:6], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tv[:6].numpy(), np.asarray(jv)[:6], rtol=1e-5,
                               atol=1e-6)


def test_model_prefill_then_decode_logits_match_jax(model):
    cfg, tcfg, jparams, tparams = model
    ps, n_pages = 16, 5  # page 4 is the trash page
    jcache = JMD.init_paged_cache(cfg, n_pages, ps, jnp.float32)
    tcache = TMD.init_paged_cache(tcfg, n_pages, ps, torch.float32, "cpu")
    prompt = [3, 9, 27, 17, 51, 1, 8]
    cs = 4
    row = np.array([2, 0], np.int32)
    for start in range(0, len(prompt), cs):
        n_valid = min(cs, len(prompt) - start)
        toks = np.zeros((1, cs), np.int32)
        toks[0, :n_valid] = prompt[start:start + n_valid]
        jl, jcache = JMD.paged_prefill_chunk(
            jparams, jnp.asarray(toks), jnp.asarray(start),
            jnp.asarray(n_valid), jnp.asarray(row), jcache, cfg,
            compute_dtype=jnp.float32)
        tl = TMD.paged_prefill_chunk(
            tparams, torch.from_numpy(toks), start, n_valid,
            torch.from_numpy(row), tcache, tcfg, compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-5)
    # batched decode: row 0 continues the prompt, row 1 is idle (trash)
    token = np.array([[int(np.asarray(jl)[0, -1].argmax())], [0]], np.int32)
    pos = np.array([len(prompt), 0], np.int32)
    table = np.array([[2, 0], [4, 4]], np.int32)
    for _ in range(3):
        jl, jcache = JMD.paged_decode_step(
            jparams, jnp.asarray(token), jnp.asarray(pos), jnp.asarray(table),
            jcache, cfg, compute_dtype=jnp.float32)
        tl = TMD.paged_decode_step(
            tparams, torch.from_numpy(token), torch.from_numpy(pos),
            torch.from_numpy(table), tcache, tcfg,
            compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                                   rtol=1e-4, atol=1e-5)
        token[0, 0] = int(np.asarray(jl)[0, 0].argmax())
        pos[0] += 1

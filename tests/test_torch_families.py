"""The port's MoE, Mamba-2, slot-cache attention, cross-attention and every
family's ``forward`` / ``prefill`` / ``decode_step`` against the JAX package
on the CPU, float32, reduced widths, JAX params carried across by
``convert.params_from_jax``; numpy inputs from fixed seeds.

Tolerances:

* MoE routing is integer and compared bitwise: the top-k indices, the
  stable argsort, the per-expert counts, each selection's rank, keep flag
  and slot, and the inverse map (the reference's per-group routing run by
  JAX on the same indices); the output within ``MOE_TOL``, with capacity
  drops (capacity factors 0.5 and 1.25) and without (100.0).
* Mamba, attention and cross-attention on shared inputs within
  ``BLOCK_TOL``: float32 rounding of the same contractions in another
  order (SSD's cumulative sums and the 3-operand decode einsum included).
* Whole models: ``forward``, then ``prefill`` of 5 tokens and 3 decode
  steps, logits within ``MODEL_TOL`` of JAX's, and (with no capacity drop)
  decode logits equal to ``forward``'s teacher-forced within the JAX
  test's 2e-3 of the largest logit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config
from repro.models import attention as JA
from repro.models import mamba as JMB
from repro.models import model as JMD
from repro.models import moe as JMOE
from repro_torch.configs import ARCH_IDS as PORT_ARCH_IDS
from repro_torch.configs import get_config as port_get_config
from repro_torch.convert import config_from_jax, params_from_jax
from repro_torch.models import attention as TA
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TMD
from repro_torch.models import moe as TMOE
from repro_torch.runtime import steps as TST

MOE_TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=5e-5)
TEACHER_REL = 2e-3  # tests/test_models_smoke.py::test_decode_matches_forward


def _np(t):
    return t.detach().numpy()


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_every_jax_config_resolves_in_the_port():
    assert PORT_ARCH_IDS == ARCH_IDS
    for arch in ARCH_IDS:
        for reduced in (False, True):
            assert port_get_config(arch, reduced) == config_from_jax(
                get_config(arch, reduced))
            assert port_get_config(arch, reduced).param_count() == get_config(
                arch, reduced).param_count()


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _jax_group_routing(topi, e, cap):
    """The reference's per-group routing (``_moe_apply_pjit.group_one``'s
    integer half) run by JAX on shared top-k indices."""
    s, k = topi.shape[1:]

    def group_one(ti):
        flat_e = ti.reshape(-1)
        order = jnp.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        counts = jnp.bincount(flat_e, length=e)
        starts = jnp.cumsum(counts) - counts
        rank = jnp.arange(s * k) - starts[sorted_e]
        keep = rank < cap
        slot = jnp.where(keep, sorted_e * cap + rank, e * cap)
        inv = jnp.zeros((s * k,), jnp.int32).at[order].set(
            slot.astype(jnp.int32))
        return dict(order=order, counts=counts, rank=rank, keep=keep,
                    slot=slot, inv=inv)

    return {k_: np.asarray(v) for k_, v in
            jax.vmap(group_one)(jnp.asarray(topi)).items()}


@pytest.fixture(scope="module")
def moe_setup():
    cfg = get_config("mixtral-8x7b", reduced=True)
    params = JMOE.init_moe_params(cfg, jax.random.PRNGKey(3))
    return cfg, config_from_jax(cfg), params, _port(params)


@pytest.mark.parametrize("capacity", [0.5, 1.25, 100.0],
                         ids=["drops", "default", "no-drops"])
def test_moe_routing_bitwise_and_output(moe_setup, capacity):
    cfg, tcfg, jp, tp = moe_setup
    rng = np.random.default_rng(11)
    x = _normal(rng, 3, 16, cfg.d_model)
    e, k, s = cfg.num_experts, cfg.num_experts_per_tok, x.shape[1]
    cap = TMOE.capacity(tcfg, s, capacity)
    assert cap == min(max(int(capacity * s * k / e), 1), s)
    # the top-k of the same router probabilities
    logits = jnp.asarray(x) @ jp["router"]
    topv, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    tv, ti = TMOE.route(torch.softmax(torch.from_numpy(np.asarray(logits)),
                                      dim=-1), k)
    np.testing.assert_array_equal(_np(ti), np.asarray(topi))
    np.testing.assert_allclose(
        _np(tv), np.asarray(topv / topv.sum(-1, keepdims=True)), **MOE_TOL)
    # the integer routing on shared indices
    want = _jax_group_routing(np.asarray(topi), e, cap)
    got = TMOE.dispatch(torch.from_numpy(np.asarray(topi)), e, cap)
    for name, w in want.items():
        np.testing.assert_array_equal(_np(got[name]), w, err_msg=name)
    dropped = int((~want["keep"]).sum())
    if capacity != 1.25:  # 0.5: 4 slots for 8 selections an expert at least
        assert (dropped > 0) == (capacity < 1.0), dropped
    out_j = JMOE.moe_apply(jp, jnp.asarray(x), cfg, capacity_factor=capacity)
    out_t = TMOE.moe_apply(tp, torch.from_numpy(x), tcfg,
                           capacity_factor=capacity)
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), **MOE_TOL)


def test_moe_aux_loss_and_equal_probabilities(moe_setup):
    cfg, tcfg, _, _ = moe_setup
    rng = np.random.default_rng(12)
    logits = _normal(rng, 2, 8, cfg.num_experts)
    topi = rng.integers(0, cfg.num_experts, (2, 8, 2)).astype(np.int32)
    want = JMOE.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(topi),
                                      cfg.num_experts)
    got = TMOE.aux_load_balance_loss(torch.from_numpy(logits),
                                     torch.from_numpy(topi), cfg.num_experts)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # equal probabilities: lax.top_k's order, the lower index first
    probs = np.full((1, 1, 4), 0.25, np.float32)
    _, ti = TMOE.route(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(
        _np(ti), np.asarray(jax.lax.top_k(jnp.asarray(probs), 2)[1]))


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba_setup():
    cfg = get_config("mamba2-370m", reduced=True)
    params = JMB.init_mamba_params(cfg, jax.random.PRNGKey(4))
    # a nonzero bias and skip, so that every term is exercised
    params = dict(params, dt_bias=jnp.full_like(params["dt_bias"], 0.3),
                  conv_b=jnp.full_like(params["conv_b"], 0.05))
    return cfg, config_from_jax(cfg), params, _port(params)


def test_mamba_forward_states_and_decode(mamba_setup):
    """S = 21 (chunk 16: one full and one padded chunk), then 3 recurrent
    steps from the returned state; and the chunked final state equal to
    the token-by-token recurrence of the port itself."""
    cfg, tcfg, jp, tp = mamba_setup
    assert 21 % cfg.ssm_chunk != 0
    rng = np.random.default_rng(13)
    x = _normal(rng, 2, 24, cfg.d_model)
    fwd = jax.jit(lambda p, a: JMB.mamba_forward(p, a, cfg,
                                                 return_state=True))
    out_j, st_j = fwd(jp, jnp.asarray(x[:, :21]))
    out_t, st_t = TMB.mamba_forward(tp, torch.from_numpy(x[:, :21]), tcfg,
                                    return_state=True)
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), **BLOCK_TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(_np(st_t[name]), np.asarray(st_j[name]),
                                   **BLOCK_TOL, err_msg=name)
    dec = jax.jit(lambda p, a, c: JMB.mamba_decode_step(p, a, cfg, c))
    for t in range(21, 24):
        o_j, st_j = dec(jp, jnp.asarray(x[:, t:t + 1]), st_j)
        o_t = TMB.mamba_decode_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                    tcfg, st_t)  # st_t advances in place
        np.testing.assert_allclose(_np(o_t), np.asarray(o_j), **BLOCK_TOL)
        np.testing.assert_allclose(_np(st_t["ssm"]), np.asarray(st_j["ssm"]),
                                   **BLOCK_TOL)
    # a short stream (S < K - 1) pads its conv tail, as JAX does
    _, short_j = fwd(jp, jnp.asarray(x[:, :2]))
    _, short_t = TMB.mamba_forward(tp, torch.from_numpy(x[:, :2]), tcfg,
                                   return_state=True)
    np.testing.assert_allclose(_np(short_t["conv"]),
                               np.asarray(short_j["conv"]), **BLOCK_TOL)
    # the chunked SSD's state after 24 tokens = 24 recurrent steps
    _, chunked = TMB.mamba_forward(tp, torch.from_numpy(x), tcfg,
                                   return_state=True)
    rec = TMB.init_mamba_cache(tcfg, 2, device="cpu")
    for t in range(24):
        TMB.mamba_decode_step(tp, torch.from_numpy(x[:, t:t + 1]), tcfg, rec)
    np.testing.assert_allclose(_np(rec["ssm"]), _np(chunked["ssm"]),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(_np(rec["conv"]), _np(chunked["conv"]))


# ---------------------------------------------------------------------------
# slot-cache attention and cross-attention
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def attn_setup():
    cfg = get_config("qwen3-14b", reduced=True)
    params = JA.init_attn_params(cfg, jax.random.PRNGKey(5))
    cross = JA.init_cross_attn_params(cfg, jax.random.PRNGKey(6))
    return cfg, config_from_jax(cfg), params, _port(params), cross, \
        _port(cross)


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("window", [None, 4], ids=["global", "window4"])
def test_prefill_with_cache_and_decode_step(attn_setup, kv, window):
    cfg, tcfg, jp, tp, _, _ = attn_setup
    rng = np.random.default_rng(14)
    b, s, max_len = 2, 7, 12
    x = _normal(rng, b, s + 3, cfg.d_model)
    pos = np.broadcast_to(np.arange(s), (b, s))
    out_j, (k_j, v_j) = jax.jit(lambda p, a, q: JA.prefill_with_cache(
        p, a, cfg, q, window, max_len))(jp, jnp.asarray(x[:, :s]),
                                        jnp.asarray(pos))
    out_t, (k_t, v_t) = TA.prefill_with_cache(
        tp, torch.from_numpy(x[:, :s]), tcfg, torch.from_numpy(pos.copy()),
        window, max_len)
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), **BLOCK_TOL)
    np.testing.assert_allclose(_np(k_t), np.asarray(k_j), **BLOCK_TOL)
    np.testing.assert_allclose(_np(v_t), np.asarray(v_j), **BLOCK_TOL)
    if kv == "int8":  # a cache of integers on the quantisation grid
        k_j, v_j = (jnp.clip(jnp.round(a / JA.KV_INT8_SCALE), -127, 127)
                    .astype(jnp.int8) for a in (k_j, v_j))
    ck, cv = (torch.from_numpy(np.array(a)) for a in (k_j, v_j))
    # rows at different positions: row 1 is two tokens behind
    rows_pos = np.array([s, s - 2], np.int32)
    dec = jax.jit(lambda prm, a, k, v, q: JA.decode_step(prm, a, cfg, k, v, q,
                                                         window))
    for step in range(3):
        p = rows_pos + step
        xt = x[np.arange(b), p][:, None]
        o_j, (k_j, v_j) = dec(jp, jnp.asarray(xt), k_j, v_j, jnp.asarray(p))
        o_t = TA.decode_step(tp, torch.from_numpy(xt), tcfg, ck, cv,
                             torch.from_numpy(p), window)
        np.testing.assert_allclose(_np(o_t), np.asarray(o_j), **BLOCK_TOL)
        assert ck.dtype == (torch.int8 if kv == "int8" else torch.float32)
        if kv == "int8":  # quantised writes: the same integers
            np.testing.assert_array_equal(_np(ck), np.asarray(k_j))
            np.testing.assert_array_equal(_np(cv), np.asarray(v_j))
        else:
            np.testing.assert_allclose(_np(ck), np.asarray(k_j), **BLOCK_TOL)


def test_cross_attention(attn_setup):
    cfg, tcfg, _, _, jc, tc = attn_setup
    rng = np.random.default_rng(15)
    x, enc = _normal(rng, 2, 5, cfg.d_model), _normal(rng, 2, 9, cfg.d_model)
    want = JA.cross_attention(jc, jnp.asarray(x), jnp.asarray(enc), cfg)
    got = TA.cross_attention(tc, torch.from_numpy(x), torch.from_numpy(enc),
                             tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **BLOCK_TOL)
    # the decoder's cached read of the same encoder K/V, one token
    nkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    xk = torch.from_numpy(enc) @ tc["wk"]
    xv = torch.from_numpy(enc) @ tc["wv"]
    one = TA.cross_decode(tc, torch.from_numpy(x[:, :1]),
                          xk.reshape(2, 9, nkv, hd), xv.reshape(2, 9, nkv, hd),
                          tcfg)
    np.testing.assert_allclose(_np(one), np.asarray(want)[:, :1], **BLOCK_TOL)


# ---------------------------------------------------------------------------
# whole models: forward, prefill, decode
# ---------------------------------------------------------------------------

NEW_ARCHS = [a for a in ARCH_IDS if a != "qwen3-14b"]


def _model_cfg(arch):
    cfg = get_config(arch, reduced=True)
    if arch == "qwen3-moe-30b-a3b":
        cfg = dataclasses.replace(cfg, moe_capacity=100.0)  # no drops
    if cfg.is_hybrid:  # one period of 4 layers, LUT-MU MLPs in the dense ones
        cfg = dataclasses.replace(cfg, num_layers=cfg.attn_every,
                                  amm=dataclasses.replace(cfg.amm,
                                                          enabled=True))
    return cfg


def _drops(cfg, s):
    """Whether a group of ``s`` tokens can lose a selection to capacity
    (an expert has fewer than ``s`` slots)."""
    return cfg.is_moe and TMOE.capacity(config_from_jax(cfg), s) < s


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    """mixtral keeps its default capacity (its 5-token prefill drops),
    qwen3-moe takes 100.0 (none); jamba, cut to one period, serves LUT-MU
    MLPs in its dense layers (``init_params(serving=True)`` with
    ``amm.enabled``); whisper gets frames and internvl patch embeddings."""
    cfg = _model_cfg(arch)
    tcfg = config_from_jax(cfg)
    # the port draws the params (no JAX compile); JAX gets the same arrays
    tp = TMD.init_params(tcfg, torch.Generator().manual_seed(0),
                         serving=True)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    rng = np.random.default_rng(16)
    b, s, n_pf, max_len = 2, 8, 5, 32
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    extra = (_normal(rng, b, cfg.num_frontend_tokens, cfg.d_model, scale=0.1)
             if cfg.is_encdec or cfg.family == "vlm" else None)
    j_extra = None if extra is None else jnp.asarray(extra)
    t_extra = None if extra is None else torch.from_numpy(extra)
    f32 = jnp.float32

    full_j = jax.jit(lambda p, t, e: JMD.forward(
        p, t, cfg, extra_embeds=e, compute_dtype=f32))(
            jp, jnp.asarray(toks), j_extra)
    full_t = TMD.forward(tp, torch.from_numpy(toks), tcfg, remat=False,
                         extra_embeds=t_extra, compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(full_t), np.asarray(full_j), **MODEL_TOL)

    lp_j, cache_j = jax.jit(lambda p, t, e: JMD.prefill(
        p, t, cfg, max_len, extra_embeds=e, compute_dtype=f32))(
            jp, jnp.asarray(toks[:, :n_pf]), j_extra)
    lp_t, cache_t = TST.make_prefill_step(tcfg, max_len, torch.float32)(
        tp, {"tokens": torch.from_numpy(toks[:, :n_pf]),
             **({} if extra is None else {"frontend": t_extra})})
    np.testing.assert_allclose(_np(lp_t), np.asarray(lp_j), **MODEL_TOL)
    assert (jax.tree.structure(jax.tree.map(lambda a: 0, cache_j)) ==
            jax.tree.structure(jax.tree.map(lambda a: 0, {**cache_t})))
    jax.tree.map(lambda a, t: np.testing.assert_allclose(
        _np(t), np.asarray(a), **MODEL_TOL), cache_j, cache_t)

    decode_t = TST.make_decode_step(tcfg, torch.float32)
    dec_j = jax.jit(lambda p, t, pos, c: JMD.decode_step(
        p, t, pos, c, cfg, compute_dtype=f32))
    offset = cfg.num_frontend_tokens if cfg.family == "vlm" else 0
    errs = [np.abs(_np(lp_t)[:, 0] - _np(full_t)[:, n_pf - 1]).max()]
    for t in range(n_pf, s):
        pos = np.full((b,), offset + t, np.int32)
        lg_j, cache_j = dec_j(jp, jnp.asarray(toks[:, t:t + 1]),
                              jnp.asarray(pos), cache_j)
        lg_t = decode_t(tp, torch.from_numpy(toks[:, t:t + 1]),
                        torch.from_numpy(pos), cache_t)
        np.testing.assert_allclose(_np(lg_t), np.asarray(lg_j), **MODEL_TOL)
        errs.append(np.abs(_np(lg_t)[:, 0] - _np(full_t)[:, t]).max())
    if not _drops(cfg, s):
        assert max(errs) / np.abs(_np(full_t)).max() < TEACHER_REL, errs
    else:  # the forward's 8-token groups drop other selections
        assert _drops(cfg, n_pf)


def test_forward_needs_frames_for_encdec():
    tcfg = port_get_config("whisper-tiny", reduced=True)
    params = TMD.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="frame embeddings"):
        TMD.forward(params, torch.zeros((1, 4), dtype=torch.int64), tcfg)
    with pytest.raises(ValueError, match="frame embeddings"):
        TMD.prefill(params, torch.zeros((1, 4), dtype=torch.int64), tcfg, 8)

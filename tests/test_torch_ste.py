"""The port's straight-through LUT-MU, FINN quantisation baseline and II
model against the JAX package, on the CPU.

* ``ste_lut_matmul``: forward within 1e-5 of JAX's (float32 one-hot × LUT
  sums in another order); ``d_lut`` and ``d_x`` of a loss against
  ``jax.grad`` within 1e-5; the surrogate weight's gradient is zero in
  both.
* ``retrain_lut_layerwise``: losses and the retrained LUT within 1e-4 of
  JAX's over 30 steps; the error falls.
* ``fake_quant`` bit-equal (``torch.round`` and ``jnp.round`` both round
  half to even, shown on exact halves), its gradient straight through;
  ``thresholds_from_bn`` within 1e-6, ``successive_threshold`` and
  ``quant_params_bits`` equal; every ``ii_model`` function equal.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ii_model as JII
from repro.core import maddness as JM
from repro.core import ste as JSTE
from repro_torch.core import ii_model as TII
from repro_torch.core import ste as TSTE

# the packages' ``fake_quant`` functions shadow their modules' names
JFQ = importlib.import_module("repro.quant.fake_quant")
TFQ = importlib.import_module("repro_torch.quant.fake_quant")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Small tensors: one intra-op thread.  The suite runs in parallel
    worker processes on a few cores, where every process's default thread
    pool would oversubscribe them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(0)
    d, n, c = 32, 16, 4
    centers = rng.normal(size=(16, d)).astype(np.float32)
    idx = rng.integers(0, 16, size=512)
    x = centers[idx] + 0.05 * rng.normal(size=(512, d)).astype(np.float32)
    w = (rng.normal(size=(d, n)) / np.sqrt(d)).astype(np.float32)
    p = JM.fit_maddness(x, w, c, depth=4, optimize_prototypes=False)
    arrs = {k: np.array(v) for k, v in (("lut", p.lut),
                                        ("split", p.tree.split_dims),
                                        ("thr", p.tree.thresholds))}
    return x, w, p, arrs


def _port_args(x, w, arrs, lut=None):
    return (torch.from_numpy(x), torch.from_numpy(
        arrs["lut"] if lut is None else lut), torch.from_numpy(w),
        torch.from_numpy(arrs["split"]), torch.from_numpy(arrs["thr"]))


def test_ste_forward_and_gradients_match_jax(fitted):
    x, w, p, arrs = fitted
    xb = x[:64]
    g_out = np.random.default_rng(1).normal(size=(64, w.shape[1])).astype(
        np.float32)

    def jloss(lut, xin, ww):
        y = JSTE.ste_lut_matmul(xin, lut, ww, p.tree.split_dims,
                                p.tree.thresholds)
        return jnp.sum(y * g_out), y

    (_, jy), (jg_lut, jg_x, jg_w) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(p.lut, jnp.asarray(xb),
                                                 jnp.asarray(w))
    tx, tlut, tw, ts, tt = _port_args(xb, w, arrs)
    for t in (tx, tlut, tw):
        t.requires_grad_(True)
    ty = TSTE.ste_lut_matmul(tx, tlut, tw, ts, tt)
    torch.sum(ty * torch.from_numpy(g_out)).backward()
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(tlut.grad), np.asarray(jg_lut), **TOL)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jg_x), **TOL)
    assert not tw.grad.any() and not np.asarray(jg_w).any()
    # the forward is the inference path's one-hot aggregation
    ref = JM.maddness_matmul_onehot(jnp.asarray(xb), p)
    np.testing.assert_allclose(_np(ty), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_retrain_lut_layerwise_matches_jax(fitted):
    x, w, p, arrs = fitted
    xb = jnp.asarray(x[:256])
    target = np.asarray(xb @ jnp.asarray(w))
    jlut, jl = JSTE.retrain_lut_layerwise(
        xb, jnp.asarray(target), p.lut, jnp.asarray(w), p.tree.split_dims,
        p.tree.thresholds, steps=30, lr=0.3)
    tx, tlut, tw, ts, tt = _port_args(x[:256], w, arrs)
    tlut2, tl = TSTE.retrain_lut_layerwise(
        tx, torch.from_numpy(target), tlut, tw, ts, tt, steps=30, lr=0.3)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-4)
    np.testing.assert_allclose(_np(tlut2), np.asarray(jlut), rtol=1e-4,
                               atol=1e-4)
    assert float(tl[-1]) < 0.9 * float(tl[0])


def test_fake_quant_bit_equal_and_straight_through():
    # exact halves of the grid: both round half to even
    halves = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32) / 7
    rng = np.random.default_rng(2)
    x = np.concatenate([halves, rng.normal(size=200).astype(np.float32)])
    for bits, scale in ((4, 1.0), (8, 0.5), (2, 2.0)):
        want = np.asarray(JFQ.fake_quant(jnp.asarray(x), bits, scale))
        got = TFQ.fake_quant(torch.from_numpy(x), bits, scale)
        np.testing.assert_array_equal(_np(got), want)
    assert np.array_equal(np.round(np.array([0.5, 1.5, 2.5])), [0, 2, 2])
    assert torch.equal(torch.round(torch.tensor([0.5, 1.5, 2.5])),
                       torch.tensor([0.0, 2.0, 2.0]))
    t = torch.from_numpy(x).requires_grad_(True)
    (TFQ.fake_quant(t, 4, 1.0) * 3.0).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(JFQ.fake_quant(v, 4, 1.0) * 3.0))(
        jnp.asarray(x))
    np.testing.assert_array_equal(_np(t.grad), np.asarray(jg))


def test_thresholds_and_successive_threshold_match_jax():
    rng = np.random.default_rng(4)
    c = 12
    gamma = rng.uniform(0.5, 2, size=c).astype(np.float32)
    beta = rng.normal(size=c).astype(np.float32)
    mean = rng.normal(size=c).astype(np.float32)
    var = rng.uniform(0.1, 2, size=c).astype(np.float32)
    for bits in (1, 2, 4):
        jt = np.asarray(JFQ.thresholds_from_bn(*map(jnp.asarray, (
            gamma, beta, mean, var)), bits, act_scale=1.5))
        tt = TFQ.thresholds_from_bn(*map(torch.from_numpy, (
            gamma, beta, mean, var)), bits, act_scale=1.5)
        np.testing.assert_allclose(_np(tt), jt, rtol=1e-6, atol=1e-6)
        x = rng.normal(size=(5, 7, c)).astype(np.float32) * 2
        np.testing.assert_array_equal(
            _np(TFQ.successive_threshold(torch.from_numpy(x),
                                         torch.from_numpy(jt), 1.5)),
            np.asarray(JFQ.successive_threshold(jnp.asarray(x),
                                                jnp.asarray(jt), 1.5)))
    assert (TFQ.quant_params_bits((3, 3, 64, 128), 4)
            == JFQ.quant_params_bits((3, 3, 64, 128), 4))


@pytest.mark.parametrize("c_in,depth_in,c_out,depth_out,s,e", [
    (98, 4, 16, 4, 2, 1), (32, 6, 8, 4, 4, 2), (16, 4, 16, 4, 1, 4)])
def test_ii_model_matches_jax(c_in, depth_in, c_out, depth_out, s, e):
    jc = JII.LutMuConfig(c_in, depth_in, c_out, depth_out, s=s, e=e)
    tc = TII.LutMuConfig(c_in, depth_in, c_out, depth_out, s=s, e=e)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for fn in ("initiation_interval", "resources", "power_proxy_mw",
               "throughput_fps"):
        assert getattr(TII, fn)(tc) == getattr(JII, fn)(jc), fn
    for cfg in ((jc, tc), (dataclasses.replace(jc, s=3),
                           dataclasses.replace(tc, s=3))):
        outcomes = []
        for c in cfg:
            try:
                c.validate()
                outcomes.append(None)
            except ValueError as err:
                outcomes.append(str(err))
        assert outcomes[0] == outcomes[1]

"""The port's MADDNESS online path, pruning, and ``lutmu_matmul`` against
the JAX package on the same numpy inputs (CPU).

Codes, one-hots, gathers and int8-LUT results with a unit epilogue match
bit for bit; float LUTs and real epilogues within rtol 1e-5 (float32 sums
of a few tens of terms in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import maddness as JM
from repro.core import pruning as JP
from repro.kernels import dispatch as JD
from repro_torch.core import maddness as TM
from repro_torch.core import pruning as TP
from repro_torch.kernels import dispatch as TD

B, D, N, DEPTH, D_SUB = 6, 32, 48, 3, 4


def _trees(rng, c, depth, d_sub):
    split = rng.integers(0, d_sub, size=(c, depth)).astype(np.int32)
    thr = (rng.normal(size=(c, 2**depth - 1)) * 0.5).astype(np.float32)
    return split, thr


def _both_trees(split, thr):
    return (JM.HashTree(jnp.asarray(split), jnp.asarray(thr)),
            TM.HashTree(torch.from_numpy(split), torch.from_numpy(thr)))


@pytest.fixture
def setup():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, D)).astype(np.float32)
    split, thr = _trees(rng, D // D_SUB, DEPTH, D_SUB)
    jt, tt = _both_trees(split, thr)
    return rng, x, jt, tt


def test_gather_encode_onehot_match_jax(setup):
    _, x, jt, tt = setup
    jxs = JM.gather_split_values(jnp.asarray(x), jt)
    txs = TM.gather_split_values(torch.from_numpy(x), tt)
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    codes = TM.encode(txs, tt)
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(JM.encode(jxs, jt)))
    onehot = TM.encode_onehot(txs, tt)
    np.testing.assert_array_equal(onehot.numpy(),
                                  np.asarray(JM.encode_onehot(jxs, jt)))
    # the parallel comparators agree with the sequential walk
    np.testing.assert_array_equal(onehot.argmax(-1).numpy(), codes.numpy())


@pytest.mark.parametrize("lut_dtype", ["int8", "float32"])
def test_aggregate_and_contract_match_jax(setup, lut_dtype):
    rng, x, jt, tt = setup
    c, g = tt.num_codebooks, tt.num_prototypes
    if lut_dtype == "int8":
        lut = rng.integers(-128, 128, size=(c, g, N)).astype(np.int8)
    else:
        lut = rng.normal(size=(c, g, N)).astype(np.float32)
    scale = rng.uniform(0.01, 0.02, size=(N,)).astype(np.float32)
    offset = rng.normal(size=(N,)).astype(np.float32)
    jxs = JM.gather_split_values(jnp.asarray(x), jt)
    txs = TM.gather_split_values(torch.from_numpy(x), tt)
    jargs = (jnp.asarray(lut), jnp.asarray(scale), jnp.asarray(offset))
    targs = (torch.from_numpy(lut), torch.from_numpy(scale),
             torch.from_numpy(offset))
    want = np.asarray(JM.aggregate(JM.encode(jxs, jt), *jargs))
    got = TM.aggregate(TM.encode(txs, tt), *targs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want_c = np.asarray(JM.contract_onehot(JM.encode_onehot(jxs, jt), *jargs))
    got_c = TM.contract_onehot(TM.encode_onehot(txs, tt), *targs).numpy()
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_c, got, rtol=1e-5, atol=1e-5)


def test_pruning_plan_and_package_round_trip():
    """Plan, LUT pruning and the cluster-ordered package: level ``l`` of
    codebook ``c`` at ``l·C' + c`` — decoding it is a reshape to (B, I, C)
    and a transpose, and must equal gathering the full activation."""
    rng = np.random.default_rng(11)
    d_in, c_cons, depth = 24, 6, 3
    split, thr = _trees(rng, c_cons, depth, d_in // c_cons)
    jt, tt = _both_trees(split, thr)
    jplan = JP.plan_from_consumer_tree(jt, consumer_in_dim=d_in)
    tplan = TP.plan_from_consumer_tree(tt, consumer_in_dim=d_in)
    np.testing.assert_array_equal(tplan.keep_idx.numpy(),
                                  np.asarray(jplan.keep_idx))
    assert (tplan.consumer_codebooks, tplan.consumer_depth) == (c_cons, depth)
    assert tplan.num_kept == jplan.num_kept

    lut = rng.normal(size=(5, 8, d_in)).astype(np.float32)
    off = rng.normal(size=(d_in,)).astype(np.float32)
    jl, jo = JP.prune_lut(jnp.asarray(lut), jnp.asarray(off), jplan)
    tl, to = TP.prune_lut(torch.from_numpy(lut), torch.from_numpy(off), tplan)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))

    h = rng.normal(size=(4, d_in)).astype(np.float32)
    pkg = TP.prune_activations(torch.from_numpy(h), tplan)
    np.testing.assert_array_equal(
        pkg.numpy(), np.asarray(JP.prune_activations(jnp.asarray(h), jplan)))
    split_vals = TP.pruned_to_split_values(pkg, tplan)
    np.testing.assert_array_equal(
        split_vals.numpy(),
        np.asarray(JP.pruned_to_split_values(jnp.asarray(pkg.numpy()), jplan)))
    # the round trip: package decode == gathering the consumer's split dims
    np.testing.assert_array_equal(
        split_vals.numpy(),
        TM.gather_split_values(torch.from_numpy(h), tt).numpy())


def _params(rng, lut_dtype, c, depth, n, d_sub):
    split, thr = _trees(rng, c, depth, d_sub)
    g = 2**depth
    if lut_dtype == "int8":
        lut = rng.integers(-128, 128, size=(c, g, n)).astype(np.int8)
    else:
        lut = rng.normal(size=(c, g, n)).astype(np.float32)
    scale = rng.uniform(0.01, 0.02, size=(n,)).astype(np.float32)
    offset = rng.normal(size=(n,)).astype(np.float32)
    arrays = (split, thr, lut, scale, offset)
    return (JD.params_from_arrays(*map(jnp.asarray, arrays)),
            TD.params_from_arrays(*map(torch.from_numpy, arrays)))


@pytest.mark.parametrize("backend", ["auto", "ref", "unfused", "fused"])
@pytest.mark.parametrize("input_kind", ["full", "split", "package"])
@pytest.mark.parametrize("lut_dtype", ["int8", "float32"])
def test_lutmu_matmul_matches_jax(backend, input_kind, lut_dtype):
    rng = np.random.default_rng(5)
    c, depth, n, d_sub = 8, 3, 40, 4
    jp, tp = _params(rng, lut_dtype, c, depth, n, d_sub)
    if input_kind == "full":
        x = rng.normal(size=(B, c * d_sub))
    elif input_kind == "split":
        x = rng.normal(size=(B, c, depth))
    else:
        x = rng.normal(size=(B, depth * c))
    x = x.astype(np.float32)
    # the same backend on the JAX side (its Pallas kernels in interpret
    # mode); "auto" is "ref" on the CPU in both packages
    jb = "ref" if backend == "auto" else backend
    want = np.asarray(JD.lutmu_matmul(jnp.asarray(x), jp, backend=jb,
                                      input_kind=input_kind))
    got = TD.lutmu_matmul(torch.from_numpy(x), tp, backend=backend,
                          input_kind=input_kind)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_select_backend_rules():
    assert TD.select_backend(4, 640, 8704, 4, torch.int8, "cpu") == "ref"
    # CUDA: no TPU minimum tiles — a one-row int8 decode still fuses
    assert TD.select_backend(1, 640, 8704, 4, torch.int8, "cuda") == "fused"
    assert TD.select_backend(1, 8, 64, 4, torch.float32, "cuda") == "fused"
    # many N-tiles × deep trees, float LUTs → unfused
    assert TD.select_backend(32, 64, 8704, 6, torch.float32, "cuda") == "unfused"
    assert TD.select_backend(32, 64, 8704, 4, torch.float32, "cuda") == "fused"


def test_auto_resolves_to_ref_on_cpu_and_env_override(monkeypatch):
    rng = np.random.default_rng(9)
    _, tp = _params(rng, "int8", 4, 2, 16, 4)
    x = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    seen = []
    TD.set_profile_hook(lambda **kw: seen.append(kw["backend"]))
    try:
        TD.lutmu_matmul(x, tp)
        monkeypatch.setenv("REPRO_LUTMU_BACKEND", "fused")
        TD.lutmu_matmul(x, tp)
        with pytest.raises(ValueError):
            TD.lutmu_matmul(x, tp, backend="nope")
    finally:
        TD.set_profile_hook(None)
    assert seen == ["ref", "fused"]

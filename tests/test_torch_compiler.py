"""The port's offline compiler against the JAX package's, on the CPU.

* The fit (``core/maddness.py``): hash trees from the same seeded float64
  arrays are bitwise the JAX package's — split dims and thresholds — except
  where two losses of a pick lie within 1e-12 relative of each other
  (``compare_trees``: such a near-tie may resolve either way under another
  rounding, and is named, never silently passed); prototypes (bucket means
  and the ridge solution) within rtol 1e-5 / atol 1e-6 of float32 (float64
  sums and a Cholesky in place of LU); float LUTs from shared prototypes
  within rtol 1e-5 / atol 1e-5 (float32 sums of D products in another
  order).
* Quantisation from shared float tables is bitwise: ``quantize_lut_bits``
  (its offsets summed in XLA's order), ``quantize_lut``,
  ``quantize_amm_layer`` at int8/int4 and their int4 packing; the resource
  report is equal.
* ``compile_chain`` is compared layer by layer on shared inputs — JAX's
  layer-i calibration input into the port's ``calibrate_layer`` — since a
  last-bit difference in one layer's LUT can flip the next layer's encode
  (ROADMAP C2); the manifests are equal but for ``platform``, ``backend``
  and ``tiles``.
* ``compile_lm_amm`` / ``compile_lm_bundle`` from params carried across by
  ``convert.py``: either package loads the other's artifact and bundle, and
  the port engine serves the port-compiled artifact with the JAX engine's
  streams on the same directory.
* The CLI (``lm``, ``bundle``, ``inspect``, ``verify`` on the CPU;
  ``--mesh`` exits naming its ROADMAP item; ``mlp`` and ``--ckpt`` are in
  ``test_torch_train.py``) and the launcher's in-process bundle compile.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler import artifact as JA
from repro.compiler import calibrate as JC
from repro.compiler import compile_chain as jax_compile_chain
from repro.compiler import compile_lm_amm as jax_compile_lm_amm
from repro.compiler import compile_lm_bundle as jax_compile_lm_bundle
from repro.compiler import quantize as JQ
from repro.configs import get_config
from repro.core import maddness as JM
from repro.models import amm_mlp as JAMM
from repro.models import model as JMD
from repro.serving import load_engine as jax_load_engine
from repro_torch import compiler as TC
from repro_torch.compiler import __main__ as cli
from repro_torch.compiler import calibrate as TCAL
from repro_torch.compiler import quantize as TQ
from repro_torch.configs import get_config as port_get_config
from repro_torch.convert import config_from_jax, params_from_jax
from repro_torch.core import maddness as TM
from repro_torch.data import TokenStream
from repro_torch.launch import serve as port_serve
from repro_torch.models import amm_mlp as TAMM
from repro_torch.models.model import init_params as port_init_params
from repro_torch.serving import SpeculativeEngine, load_engine

PROTO_TOL = dict(rtol=1e-5, atol=1e-6)
LUT_TOL = dict(rtol=1e-5, atol=1e-5)
NEAR_TIE = 1e-12


def _data(kind: str, n: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "gauss":
        return rng.normal(size=(n, d))
    if kind == "clustered":  # duplicated rows: tied values on every dim
        centres = rng.normal(size=(8, d))
        return centres[rng.integers(0, 8, n)] + 0.01 * rng.normal(size=(n, d))
    # "few": fewer rows than leaves — empty and one-row buckets
    return rng.normal(size=(n, d)).round(1)


def _bucket_sizes(x: np.ndarray, tree, c_books: int) -> np.ndarray:
    d_sub = x.shape[1] // c_books
    sizes = []
    for c in range(c_books):
        codes = JM._assign_buckets_np(x[:, c * d_sub:(c + 1) * d_sub],
                                      np.asarray(tree.split_dims)[c],
                                      np.asarray(tree.thresholds)[c])
        sizes.append(np.bincount(codes, minlength=2**tree.depth))
    return np.stack(sizes)


def assert_same_trees(port_tree, jax_tree, margins):
    """Bitwise, except near-ties, which are named."""
    want = TM.HashTree(torch.from_numpy(np.array(jax_tree.split_dims)),
                       torch.from_numpy(np.array(jax_tree.thresholds)))
    excused, unexcused = TM.compare_trees(port_tree, want, margins, NEAR_TIE)
    assert not unexcused, f"trees differ beyond a near-tie at {unexcused}"
    if excused:
        print(f"near-ties (codebook, level) excused: {excused}")
    return excused


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("kind,n", [("gauss", 300), ("clustered", 200),
                                    ("few", 6)])
def test_hash_trees_bitwise_jax(kind, n, depth):
    x = _data(kind, n, 24, seed=depth)
    jt = JM.learn_hash_trees(x, 3, depth)
    pt, margins = TM.learn_hash_trees(x, 3, depth, margins=True)
    assert pt.split_dims.dtype == torch.int32
    assert pt.thresholds.dtype == torch.float32
    assert_same_trees(pt, jt, margins)
    if kind == "few" and depth >= 3:
        sizes = _bucket_sizes(x, jt, 3)
        assert (sizes == 0).any() and (sizes == 1).any(), sizes


def test_near_tie_is_named_not_passed():
    """Two dims with identical columns tie exactly: the rule excuses a
    disagreement there and nowhere else."""
    x = _data("gauss", 64, 8, seed=5)
    x[:, 1] = x[:, 0]
    pt, margins = TM.learn_hash_trees(x, 1, 2, margins=True)
    assert float(margins["dim"][0, 0]) <= NEAR_TIE  # dims 0 and 1 tie
    other = TM.HashTree(pt.split_dims.clone(), pt.thresholds.clone())
    other.split_dims[0, 0] = 1 - other.split_dims[0, 0]
    assert TM.compare_trees(pt, other, margins) == ([(0, 0)], [])
    # level 1 has no near-tie: a threshold moved there is a fault
    assert float(margins["dim"][0, 1]) > NEAR_TIE
    assert bool((margins["cut"][0, 1:3] > NEAR_TIE).all())
    far = TM.HashTree(pt.split_dims.clone(), pt.thresholds.clone())
    far.thresholds[0, 1] += 1.0
    assert TM.compare_trees(pt, far, margins) == ([], [(0, 1)])


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("kind", ["gauss", "few"])
def test_prototypes_match_jax(kind, optimize):
    x = _data(kind, 300 if kind == "gauss" else 9, 32, seed=7)
    jt = JM.learn_hash_trees(x, 4, 3)
    tree = TM.HashTree(torch.from_numpy(np.array(jt.split_dims)),
                       torch.from_numpy(np.array(jt.thresholds)))
    want = np.asarray(JM.learn_prototypes(x, jt, optimize=optimize))
    got = TM.learn_prototypes(x, tree, optimize=optimize)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **PROTO_TOL)
    # a float32 input (the down projection's activations) as well
    x32 = x.astype(np.float32)
    np.testing.assert_allclose(
        TM.learn_prototypes(x32, tree, optimize=optimize).numpy(),
        np.asarray(JM.learn_prototypes(x32, jt, optimize=optimize)),
        **PROTO_TOL)


@pytest.mark.parametrize("width", ["full", "subspace"])
@pytest.mark.parametrize("quantize", [False, True])
def test_build_lut_matches_jax(width, quantize):
    rng = np.random.default_rng(3)
    pdim = 64 if width == "full" else 8
    protos = rng.normal(size=(8, 16, pdim)).astype(np.float32)
    w = rng.normal(size=(64, 40)).astype(np.float32)
    bias = rng.normal(size=(40,)).astype(np.float32)
    jl, js, jo = JM.build_lut(jnp.asarray(protos), jnp.asarray(w),
                              jnp.asarray(bias), quantize_int8=quantize)
    tl, ts, to = TM.build_lut(torch.from_numpy(protos), torch.from_numpy(w),
                              torch.from_numpy(bias), quantize_int8=quantize)
    if not quantize:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LUT_TOL)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert float(ts) == float(js) == 1.0
    else:  # quantised from the JAX float table, the codes are JAX's
        jf, _, _ = JM.build_lut(jnp.asarray(protos), jnp.asarray(w))
        q, s, o = TM.quantize_lut_bits(torch.from_numpy(np.array(jf)), 8,
                                       torch.from_numpy(bias))
        for a, b in ((q, jl), (s, js), (o, jo)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("c_books", [3, 40, 640, 2176])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("with_bias", [False, True])
def test_quantize_lut_bits_bitwise_jax(c_books, bits, with_bias):
    """C = 640 and 2176 are qwen3-14b's codebook counts: the offsets' sum
    over codebooks follows XLA's tree reduction there."""
    rng = np.random.default_rng(c_books + bits)
    n = 24
    lut = (rng.normal(size=(c_books, 16, n))
           * rng.uniform(0.01, 3.0, size=(1, 1, n))).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32) if with_bias else None
    jq, js, jo = JM.quantize_lut_bits(
        jnp.asarray(lut), bits, None if bias is None else jnp.asarray(bias))
    tq, ts, to = TM.quantize_lut_bits(
        torch.from_numpy(lut), bits,
        None if bias is None else torch.from_numpy(bias))
    assert tq.dtype == torch.int8
    for a, b in ((tq, jq), (ts, js), (to, jo)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantize_lut_bitwise_jax(bits):
    rng = np.random.default_rng(bits)
    lut = rng.normal(size=(6, 16, 33)).astype(np.float32)
    offset = rng.normal(size=(33,)).astype(np.float32)
    for off in (None, offset):
        want = JQ.quantize_lut(lut, off, bits)
        got = TQ.quantize_lut(lut, off, bits)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TQ.dequantize_lut(want[0]),
                                  JQ.dequantize_lut(want[0]))


def test_resource_report_equal():
    for shapes in ([(98, 4, 128, 256), (32, 4, 128, 256), (32, 4, 10, 10)],
                   [(640, 4, 8704, 17408), (2176, 4, 5120, 5120)]):
        assert TQ.resource_report(shapes) == JQ.resource_report(shapes)
        assert (TQ.resource_report(shapes, ("int8",))
                == JQ.resource_report(shapes, ("int8",)))


def test_maddness_matmul_paths_match_jax():
    """The online paths the calibration propagates with: from one fitted
    int8 layer, the tree-walk and one-hot forms are bitwise JAX's."""
    x = _data("gauss", 64, 32, seed=9).astype(np.float32)
    w = _data("gauss", 32, 24, seed=10).astype(np.float32)
    jp = JM.fit_maddness(x.astype(np.float64), w, 4, depth=3,
                         quantize_int8=True)
    tp = TM.MaddnessParams(*(TM.HashTree(*(torch.from_numpy(np.array(a))
                                           for a in (jp.tree.split_dims,
                                                     jp.tree.thresholds))),),
                           None, *(torch.from_numpy(np.array(a)) for a in
                                   (jp.lut, jp.lut_scale, jp.lut_offset)))
    xt = torch.from_numpy(x)
    for jf, tf in ((JM.maddness_matmul, TM.maddness_matmul),
                   (JM.maddness_matmul_onehot, TM.maddness_matmul_onehot)):
        np.testing.assert_array_equal(tf(xt, tp).numpy(),
                                      np.asarray(jf(jnp.asarray(x), jp)))


def test_fit_amm_linear_and_chain_match_jax():
    """``fit_amm_linear`` with a pruning plan: trees bitwise, the pruned
    LUT within ``LUT_TOL``.  ``fit_amm_chain``: layer 0 as JAX's, and the
    pruned chain's output equals ``unpruned_chain``'s at every dim (pruning
    is lossless: the same trees and tables, fewer columns)."""
    from repro.core import lut_mu as JLM
    from repro_torch.core import lut_mu as TLM
    from repro_torch.core import pruning as TP

    calib, ws, bs = _toy_chain(n_calib=256)
    x = np.asarray(calib, np.float64)
    jchain = JLM.fit_amm_chain(x, ws, bs, [8, 8], [4, 4], ["relu"])
    tchain = TLM.fit_amm_chain(x, ws, bs, [8, 8], [4, 4], ["relu"])
    _, margins = TM.learn_hash_trees(x, 8, 4, margins=True)
    assert_same_trees(tchain.layers[0].params.tree,
                      jchain.layers[0].params.tree, margins)
    np.testing.assert_allclose(tchain.layers[0].params.lut.numpy(),
                               np.asarray(jchain.layers[0].params.lut),
                               **LUT_TOL)
    assert tchain.layers[0].is_pruned and not tchain.layers[1].is_pruned
    xt = torch.from_numpy(calib[:32])
    full = TLM.unpruned_chain(tchain, ws, bs)
    assert full.layers[0].params.lut.shape[-1] == ws[0].shape[1]
    torch.testing.assert_close(tchain(xt), full(xt), rtol=0, atol=0)
    plan = tchain.layers[0].out_plan
    lin = TLM.fit_amm_linear(x, ws[0], bs[0], 8, out_plan=plan)
    jlin = JLM.fit_amm_linear(x, ws[0], bs[0], 8, out_plan=JM_plan(plan))
    assert_same_trees(lin.params.tree, jlin.params.tree, margins)
    np.testing.assert_allclose(lin.params.lut.numpy(),
                               np.asarray(jlin.params.lut), **LUT_TOL)
    np.testing.assert_array_equal(lin.params.lut_offset.numpy(),
                                  np.asarray(jlin.params.lut_offset))
    assert isinstance(lin.out_plan, TP.PruningPlan)


def JM_plan(plan):
    from repro.core import pruning as JP

    return JP.PruningPlan(jnp.asarray(plan.keep_idx.numpy(), jnp.int32),
                          plan.consumer_codebooks, plan.consumer_depth)


# ---------------------------------------------------------------------------
# the AMM-MLP layer fit and its quantisation
# ---------------------------------------------------------------------------


def _amm_cfg():
    cfg = get_config("qwen3-14b", reduced=True)
    return dataclasses.replace(cfg, d_model=64, d_ff=128)


@pytest.fixture(scope="module")
def amm_layer():
    """One AMM-MLP layer fitted by both packages on the same float64
    activations and float32 weights."""
    cfg = _amm_cfg()
    rng = np.random.default_rng(11)
    x = rng.normal(size=(192, 64))
    ws = [(rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
          for s in ((64, 128), (64, 128), (128, 64))]
    jfp = JAMM.fit_from_dense_float(x, *ws, cfg, seed=2)
    tfp = TAMM.fit_from_dense_float(x, *ws, config_from_jax(cfg), seed=2)
    return cfg, x, ws, jfp, tfp


def test_amm_layer_fit_matches_jax(amm_layer):
    """The up tree is bitwise (near-ties named) and the gate/up tables
    within ``LUT_TOL``.  The down tree is fitted on ``silu(x @ W_gate) *
    (x @ W_up)``, whose float32 ``silu`` differs from XLA's (a fast
    ``exp``) in the last bit for about a third of the entries: the port's
    activations are held within 2 float32 ulps of JAX's, and the port's
    tree fit on JAX's activations is JAX's down tree."""
    cfg, x, ws, jfp, tfp = amm_layer
    jt = JM.HashTree(jfp["up_split_dims"], jfp["up_thresholds"])
    pt = TM.HashTree(tfp["up_split_dims"], tfp["up_thresholds"])
    _, margins = TM.learn_hash_trees(x, pt.num_codebooks, pt.depth,
                                     margins=True)
    assert_same_trees(pt, jt, margins)
    assert set(tfp) == set(jfp)
    for k, v in jfp.items():
        assert tuple(tfp[k].shape) == tuple(v.shape), k
        if k.startswith(("lut_gate", "lut_up")):
            np.testing.assert_allclose(tfp[k].numpy(), np.asarray(v),
                                       err_msg=k, **LUT_TOL)
    h_jax = np.asarray(jax.nn.silu(x @ ws[0]) * (x @ ws[1]))
    g = torch.from_numpy(x @ ws[0]).float()
    h_port = (torch.nn.functional.silu(g.double()).float()
              * torch.from_numpy(x @ ws[1]).float()).numpy()
    np.testing.assert_allclose(h_port, h_jax, rtol=2.4e-7, atol=1e-30)
    c_down = tfp["down_split_dims"].shape[0]
    pdown, margins = TM.learn_hash_trees(h_jax, c_down, cfg.amm.depth,
                                         margins=True)
    assert_same_trees(pdown, JM.HashTree(jfp["down_split_dims"],
                                         jfp["down_thresholds"]), margins)


@pytest.mark.parametrize("res", ["int8", "int4", "float32"])
def test_quantize_amm_layer_bitwise_from_shared_tables(amm_layer, res):
    _, _, _, jfp, _ = amm_layer
    shared = {k: torch.from_numpy(np.array(v)) for k, v in jfp.items()}
    want = JAMM.quantize_amm_layer(jfp, res)
    got = TAMM.quantize_amm_layer(shared, res)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    if res == "int4":
        for proj in ("gate", "up", "down"):
            q = got[f"lut_{proj}"].numpy()
            np.testing.assert_array_equal(TQ.pack_int4(q),
                                          JQ.pack_int4(np.asarray(q)))
    with pytest.raises(ValueError, match="int16"):
        TAMM.quantize_amm_layer(shared, "int16")


# ---------------------------------------------------------------------------
# compile_chain, layer by layer on shared inputs
# ---------------------------------------------------------------------------


def _toy_chain(seed=0, d=64, h=64, o=16, n_calib=384):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, d)).astype(np.float32)
    calib = (centers[rng.integers(0, 32, n_calib)]
             + 0.05 * rng.normal(size=(n_calib, d)).astype(np.float32))
    w0 = (rng.normal(size=(d, h)) / np.sqrt(d)).astype(np.float32)
    w1 = (rng.normal(size=(h, o)) / np.sqrt(h)).astype(np.float32)
    b0 = 0.1 * rng.normal(size=(h,)).astype(np.float32)
    b1 = 0.1 * rng.normal(size=(o,)).astype(np.float32)
    return calib, [w0, w1], [b0, b1]


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    calib, ws, bs = _toy_chain()
    root = tmp_path_factory.mktemp("torch_compile_chain")
    kw = dict(num_codebooks=[8, 8], depths=[4, 4], activations=["relu"],
              resolution="int8")
    jres = jax_compile_chain(ws, bs, calib, out=str(root / "jax"), **kw)
    tres = TC.compile_chain(ws, bs, calib, out=str(root / "port"), **kw)
    jcal = JC.calibrate_chain(ws, bs, calib, [8, 8], [4, 4], ["relu"])
    return dict(calib=calib, ws=ws, bs=bs, jres=jres, tres=tres, jcal=jcal,
                root=root)


def test_compile_chain_layer_by_layer_on_shared_inputs(chains):
    """Each layer's fit from JAX's own layer-i calibration input: trees,
    prototypes, float LUTs; the artifact's integer tables quantised by the
    port from JAX's float tables are JAX's bit for bit."""
    x = np.asarray(chains["calib"], np.float64)
    jart = chains["jres"].artifact
    for i, jcal in enumerate(chains["jcal"]):
        tcal = TCAL.calibrate_layer(x, chains["ws"][i], chains["bs"][i], 8, 4,
                                    activation=jcal.activation, seed_offset=i)
        _, margins = TM.learn_hash_trees(x, 8, 4, margins=True)
        assert_same_trees(tcal.params.tree, jcal.params.tree, margins)
        np.testing.assert_allclose(tcal.params.prototypes.numpy(),
                                   np.asarray(jcal.params.prototypes),
                                   **PROTO_TOL)
        np.testing.assert_allclose(tcal.params.lut.numpy(),
                                   np.asarray(jcal.params.lut), **LUT_TOL)
        np.testing.assert_array_equal(tcal.params.lut_offset.numpy(),
                                      np.asarray(jcal.params.lut_offset))
        # quantisation of JAX's float table, pruned as the artifact ships it
        lut = np.asarray(jcal.params.lut, np.float32)
        off = np.asarray(jcal.params.lut_offset, np.float32)
        if f"layer{i}/keep_idx" in jart.tensors:
            keep = jart.tensors[f"layer{i}/keep_idx"]
            lut, off = lut[..., keep], off[..., keep]
        q, s, o = TQ.quantize_lut(lut, off, 8)
        for k, v in (("lut", q), ("lut_scale", s), ("lut_offset", o)):
            np.testing.assert_array_equal(v, jart.tensors[f"layer{i}/{k}"])
        y = JM.maddness_matmul(jnp.asarray(x, jnp.float32), jcal.params)
        x = np.asarray(JC.ACTIVATIONS[jcal.activation](np.asarray(y)),
                       np.float64)


def test_compile_chain_manifest_equal_but_platform(chains):
    jm = dict(JA.load_artifact(chains["root"] / "jax").manifest)
    tm = dict(TC.load_artifact(chains["root"] / "port").manifest)
    assert tm["platform"] == "cuda"
    for m in (jm, tm):
        for k in ("platform", "created_unix", "tensors_sha256"):
            m.pop(k)
        m["layers"] = [{k: v for k, v in rec.items()
                        if k not in ("backend", "tiles")}
                       for rec in m["layers"]]
    assert tm == jm
    recs = TC.load_artifact(chains["root"] / "port").manifest["layers"]
    assert [r["backend"] for r in recs] == ["fused", "fused"]
    assert all(set(r["tiles"]) == {"cluster", "block_b", "block_c", "split_k"}
               for r in recs)


def test_compiled_chain_round_trips_and_loads_in_jax(chains):
    """The in-memory chain and the artifact reloaded by either package run
    the same tables: bit-equal (int8) layer outputs."""
    tres = chains["tres"]
    path = chains["root"] / "port"
    x = torch.from_numpy(chains["calib"][:64])
    mem = tres.chain(x)
    disk = TC.load_artifact(path).to_chain(device="cpu")
    assert disk.backends == ("fused", "fused")
    assert disk.layers[0].tiles == tres.chain.layers[0].tiles
    assert torch.equal(disk(x), mem)
    jchain = JA.load_artifact(path).to_chain()  # other platform: auto
    h = jnp.asarray(chains["calib"][:64])
    y0 = np.asarray(jchain.layers[0](h))
    np.testing.assert_array_equal(disk.layers[0](x).numpy(), y0)


# ---------------------------------------------------------------------------
# amm_lm artifacts and bundles from carried-across params
# ---------------------------------------------------------------------------

PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 2], [4, 4, 1, 1, 5, 6, 7]]
KNOBS = dict(max_batch=2, max_len=64, page_size=16, prefill_chunk=4)


def _streams(engine, max_new=6):
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in PROMPTS]
    engine.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs]


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """The golden setup (2 layers, d_model 64) compiled by both packages
    from the same params and calibration tokens."""
    cfg = get_config("qwen3-14b", reduced=True)
    cfg = dataclasses.replace(cfg, num_layers=2, d_model=64, d_ff=128,
                              vocab_size=64, num_heads=2, num_kv_heads=1,
                              head_dim=32)
    params = JMD.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tcfg = config_from_jax(cfg)
    calib = np.random.default_rng(0).integers(0, 64, (4, 16))
    root = tmp_path_factory.mktemp("torch_lm_compile")
    jax_compile_lm_amm(params, cfg, calib, out=str(root / "jax_lm"))
    TC.compile_lm_amm(tparams, tcfg, calib, out=str(root / "port_lm"))
    jax_compile_lm_bundle(params, cfg, calib, out=str(root / "jax_bundle"),
                          spec_k=3)
    tb = TC.compile_lm_bundle(tparams, tcfg, calib,
                              out=str(root / "port_bundle"), spec_k=3)
    return dict(cfg=cfg, params=params, tcfg=tcfg, tparams=tparams,
                root=root, tbundle=tb)


def test_either_package_loads_the_others_lm_artifact(lm):
    root = lm["root"]
    for path in (root / "jax_lm", root / "port_lm"):
        j, t = JA.load_artifact(path), TC.load_artifact(path)
        assert j.manifest == t.manifest
        assert set(j.tensors) == set(t.tensors)
        for k, v in j.tensors.items():
            np.testing.assert_array_equal(t.tensors[k], v)
    jm = JA.load_artifact(root / "jax_lm").manifest
    tm = TC.load_artifact(root / "port_lm").manifest
    assert tm["platform"] == "cuda"
    for k in ("kind", "arch", "resolution", "num_layers", "amm",
              "resource_report"):
        assert tm[k] == jm[k], k


def test_port_compiled_artifact_serves_jax_streams(lm):
    """The JAX engine and the port engine on the port-compiled directory:
    the same greedy streams."""
    path = lm["root"] / "port_lm"
    want = _streams(jax_load_engine(path, lm["params"], lm["cfg"], **KNOBS))
    got = _streams(load_engine(path, lm["tparams"], lm["tcfg"], **KNOBS,
                               compute_dtype=torch.float32, device="cpu"))
    assert all(len(s) == 6 for s in got)
    assert got == want


def test_either_package_loads_the_others_bundle(lm):
    from repro.compiler import load_bundle as jax_load_bundle

    root = lm["root"]
    for path in (root / "jax_bundle", root / "port_bundle"):
        jt, jd, jm = jax_load_bundle(path)
        tt, td, tm = TC.load_bundle(path)
        assert (tm["kind"], tm["spec_k"]) == ("bundle", 3) == (jm["kind"],
                                                              jm["spec_k"])
        assert (tt.resolution, td.resolution) == ("int8", "int4")
        assert jt.manifest == tt.manifest and jd.manifest == td.manifest
    rep = lm["tbundle"].report
    assert rep["draft_vs_target_stored"] == 2.0
    # the port bundle's target half is the port lm artifact's tables: one fit
    tl = TC.load_artifact(root / "port_lm")
    for k, v in tl.tensors.items():
        np.testing.assert_array_equal(lm["tbundle"].target.tensors[k], v)
    # served speculatively by the JAX engine: the target half's streams
    eng = jax_load_engine(root / "port_bundle", lm["params"], lm["cfg"],
                          **KNOBS)
    want = _streams(jax_load_engine(root / "port_bundle", lm["params"],
                                    lm["cfg"], speculative=False, **KNOBS))
    assert _streams(eng) == want
    port = load_engine(root / "port_bundle", lm["tparams"], lm["tcfg"],
                       **KNOBS, compute_dtype=torch.float32, device="cpu")
    assert isinstance(port, SpeculativeEngine)
    assert _streams(port) == want


def test_bundle_argument_errors_match_jax(lm):
    for kw in (dict(target_resolution="int16"), dict(draft_resolution="x"),
               dict(spec_k=0)):
        with pytest.raises(ValueError) as jerr:
            jax_compile_lm_bundle(lm["params"], lm["cfg"], np.zeros((1, 4)),
                                  **kw)
        with pytest.raises(ValueError) as terr:
            TC.compile_lm_bundle(lm["tparams"], lm["tcfg"], np.zeros((1, 4)),
                                 **kw)
        assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the CLI and the launcher
# ---------------------------------------------------------------------------

LM_ARGS = ["--arch", "qwen3-14b", "--reduced", "--device", "cpu"]


def test_cli_lm_bundle_inspect_verify(tmp_path, capsys):
    assert cli.main(["lm", *LM_ARGS, "--out", str(tmp_path / "lm")]) == 0
    out = capsys.readouterr().out
    assert "amm_lm artifact (int8)" in out and "per layer" in out
    assert cli.main(["lm", *LM_ARGS, "--resolution", "int4",
                     "--out", str(tmp_path / "lm4")]) == 0
    assert cli.main(["bundle", *LM_ARGS, "--draft-resolution", "int4",
                     "--spec-k", "2", "--out", str(tmp_path / "bd")]) == 0
    assert "draft ships 2.00x smaller" in capsys.readouterr().out
    # the JAX reader takes what the port's CLI wrote
    assert JA.load_artifact(tmp_path / "lm4").resolution == "int4"
    assert cli.main(["inspect", str(tmp_path / "lm")]) == 0
    shown = capsys.readouterr().out
    assert json.loads(shown[:shown.rindex("}") + 1])["kind"] == "amm_lm"
    assert cli.main(["inspect", str(tmp_path / "bd")]) == 0
    assert json.loads(capsys.readouterr().out)["spec_k"] == 2
    for name in ("lm", "bd"):
        assert cli.main(["verify", str(tmp_path / name)]) == 0
    assert "bundle (target=int8, draft=int4)" in capsys.readouterr().out
    # an amm_chain artifact: verify runs its forward on the CPU
    calib, ws, bs = _toy_chain(n_calib=128)
    TC.compile_chain(ws, bs, calib, num_codebooks=[8, 8], depths=[4, 4],
                     activations=["relu"], resolution="int8",
                     out=str(tmp_path / "chain"))
    assert cli.main(["verify", str(tmp_path / "chain"), "--device", "cpu"]) == 0
    assert "finite=True" in capsys.readouterr().out
    assert cli.main(["inspect", str(tmp_path / "chain")]) == 0
    assert "resource report" in capsys.readouterr().out


@pytest.mark.parametrize("argv,item", [
    (["lm", *LM_ARGS, "--mesh", "2x2"], "A11"),
    (["bundle", *LM_ARGS, "--mesh", "1x4"], "A11"),
])
def test_cli_exits_where_not_ported(argv, item, capsys):
    assert cli.main(argv) == 2
    assert item in capsys.readouterr().err


def test_launcher_compiles_a_bundle_in_process(capsys):
    """``--speculative`` without ``--artifact`` compiles an int8/int4 bundle
    from the launcher's dense params (8 × 32 TokenStream calibration
    tokens) and serves it: its streams are the bundle's target half's."""
    base = ["--arch", "qwen3-14b", "--reduced", "--device", "cpu",
            "--requests", "2", "--max-new", "3"]
    port_serve.main(base + ["--speculative", "--spec-k", "2"])
    out = capsys.readouterr().out
    assert "[spec] k=2 " in out
    lines = [line for line in out.splitlines() if line.startswith("  req ")]
    got = [[int(t) for t in line.split("→ [")[1].rstrip("]").split(", ")]
           for line in lines]
    cfg = port_get_config("qwen3-14b", reduced=True)
    params = port_init_params(cfg, torch.Generator().manual_seed(0),
                              torch.float32)
    tokens = TokenStream(vocab_size=cfg.vocab_size, batch_size=8,
                         seq_len=32).batch(0)["tokens"]
    res = TC.compile_lm_bundle(params, cfg, tokens, spec_k=2)
    eng = load_engine(res.target, params, cfg, max_batch=2, max_len=128,
                      page_size=16, prefill_chunk=32,
                      compute_dtype=torch.float32, device="cpu")
    hs = [eng.submit(p, max_new_tokens=3)
          for p in port_serve.cli_prompts(None, 2, cfg.vocab_size)]
    eng.run_until_drained()
    assert got == [h.generated for h in hs]

"""The port's artifact reader and writer, int4 packing and ``AMMChain``
against the JAX package, on ``tests/test_compiler.py``'s small setup.

The JAX compiler writes ``amm_chain`` artifacts at all four resolution
configs; the port reads the same manifest and bit-equal tensors, and its
``AMMChain.load`` matches JAX's layer by layer on shared inputs (ROADMAP
C2: a chained float path is compared layer by layer, since a last-bit
difference in one layer can flip the next layer's encode).  Integer
resolutions must be bit-equal; float32 LUT sums are taken in another order
(XLA's one-hot matmul against the port's gather-sum over ≤ 8 codebooks),
so they are held within rtol 1e-5 / atol 1e-5.  Artifacts and bundles
written by either package load in the other, and every ``ArtifactError``
of the JAX reader is raised by the port's on the same directory.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler import artifact as JA
from repro.compiler import compile_chain
from repro.compiler import quantize as JQ
from repro.core import lut_mu as JLM
from repro.core import pruning as JP
from repro_torch.compiler import artifact as TA
from repro_torch.compiler import pack_amm_lm
from repro_torch.compiler import quantize as TQ
from repro_torch.configs import get_config
from repro_torch.core import lut_mu as TLM
from repro_torch.core import pruning as TP
from repro_torch.models.amm_mlp import init_amm_mlp_params

RESOLUTIONS = ("float32", "int16", "int8", "int4")
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)


def _toy_problem(seed=0, d=64, h=64, o=16, n_calib=1024):
    """``tests/test_compiler.py``'s setup: a two-layer cascade whose inputs
    cluster around 32 centres."""
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
def arts(tmp_path_factory):
    """JAX-compiled chain artifacts, one directory per resolution config,
    and the calibration inputs."""
    calib, ws, bs = _toy_problem()
    root = tmp_path_factory.mktemp("torch_artifacts")
    out = {}
    for res in RESOLUTIONS:
        compile_chain(ws, bs, calib, num_codebooks=[8, 8], depths=[4, 4],
                      activations=["relu"], resolution=res,
                      out=str(root / res))
        out[res] = root / res
    gelu = root / "gelu-int8"
    compile_chain(ws, bs, calib, num_codebooks=[8, 8], depths=[4, 4],
                  activations=["gelu"], resolution="int8", out=str(gelu))
    return dict(dirs=out, gelu=gelu, calib=calib, root=root)


def _assert_same_artifact(port_art, jax_art):
    assert port_art.manifest == jax_art.manifest
    assert set(port_art.tensors) == set(jax_art.tensors)
    for k, v in jax_art.tensors.items():
        got = port_art.tensors[k]
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert np.array_equal(got, v), k


def _layer_io(jax_chain, x):
    """Each layer's input (the shared input the test feeds both packages)
    and JAX's output, with the chain's activations between layers."""
    ins, outs = [], []
    h = jnp.asarray(x)
    for i, layer in enumerate(jax_chain.layers):
        ins.append(np.asarray(h))
        y = layer(h) if i == 0 else (
            layer.apply_package(h) if jax_chain.layers[i - 1].is_pruned
            else layer(h))
        outs.append(np.asarray(y))
        if i < len(jax_chain.layers) - 1:
            h = JLM.AMMChain._ACTS[jax_chain.activation_names[i]](y)
    return ins, outs


def _port_layer(chain, i, h):
    t = torch.from_numpy(np.array(h))
    if i > 0 and chain.layers[i - 1].is_pruned:
        return chain.layers[i].apply_package(t).numpy()
    return chain.layers[i](t).numpy()


@pytest.mark.parametrize("res", RESOLUTIONS)
def test_port_reads_jax_artifact(arts, res):
    """Same manifest, bit-equal tensors of the same dtypes."""
    path = arts["dirs"][res]
    port, ref = TA.load_artifact(path), JA.load_artifact(path)
    _assert_same_artifact(port, ref)
    assert (port.kind, port.resolution) == ("amm_chain", res)
    assert port.resource_report == ref.resource_report


@pytest.mark.parametrize("res", RESOLUTIONS)
def test_chain_layer_by_layer_matches_jax(arts, res):
    path = arts["dirs"][res]
    port = TLM.AMMChain.load(path, device="cpu")
    ref = JLM.AMMChain.load(path)
    x = arts["calib"][:128]
    ins, outs = _layer_io(ref, x)
    for i, (h, want) in enumerate(zip(ins, outs)):
        got = _port_layer(port, i, h)
        assert got.dtype == np.float32 and got.shape == want.shape
        if res == "float32":
            np.testing.assert_allclose(got, want, **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(got, want)
    # the runtime LUT type each resolution config names
    want_dtype = TQ.get_resolution(res).runtime_dtype
    assert all(l.params.lut.dtype == want_dtype for l in port.layers)
    assert port.lut_bytes() == ref.lut_bytes()
    assert port.workload_ops() == ref.workload_ops()
    # a JAX artifact records platform "cpu": its backends are provenance
    # only in the port, and "auto" re-decides
    assert port.backends is None
    forced = TA.load_artifact(path).to_chain(True, device="cpu")
    assert forced.backends == ref.backends


@pytest.mark.parametrize("n", [1, 6, 7, 33])
def test_int4_pack_unpack_bit_equal_to_jax(n):
    rng = np.random.default_rng(n)
    q = rng.integers(-8, 8, size=(3, 16, n)).astype(np.int8)
    packed = TQ.pack_int4(q)
    want = JQ.pack_int4(q)
    assert packed.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(packed, want)
    assert packed.shape == (3, 16, (n + 1) // 2)
    np.testing.assert_array_equal(TQ.unpack_int4(packed, n), q)
    raw = rng.integers(0, 256, size=(2, 4, (n + 1) // 2)).astype(np.uint8)
    got, ref = TQ.unpack_int4(raw, n), JQ.unpack_int4(raw, n)
    assert got.dtype == ref.dtype == np.int8
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        TQ.pack_int4(q.astype(np.int16))


def test_resolution_configs_match_jax():
    assert list(TQ.RESOLUTIONS) == list(JQ.RESOLUTIONS)
    for name, rc in TQ.RESOLUTIONS.items():
        jrc = JQ.RESOLUTIONS[name]
        assert (rc.name, rc.bits, rc.storage_bits, rc.is_float) == (
            jrc.name, jrc.bits, jrc.storage_bits, jrc.is_float)
        assert str(rc.runtime_dtype).split(".")[-1] == jnp.dtype(
            jrc.runtime_dtype).name
    with pytest.raises(ValueError, match="unknown resolution"):
        TQ.get_resolution("int2")


@pytest.mark.parametrize("shape", [(8, 4, 16), (98, 4, 128), (32, 3, 10)])
def test_workload_ops_matches_jax(shape):
    assert TP.workload_ops(*shape) == JP.workload_ops(*shape)


@pytest.mark.parametrize("res", RESOLUTIONS)
def test_port_written_artifact_loads_in_jax(arts, res, tmp_path):
    """The port's writer: JAX reads what it wrote (same tensors, same
    records), and the JAX chain over it computes what the original does."""
    src = TA.load_artifact(arts["dirs"][res])
    manifest = {k: v for k, v in src.manifest.items()
                if k not in ("tensors_sha256", "created_unix")}
    manifest["platform"] = TA.PLATFORM
    out = TA.save_artifact(tmp_path / "port", TA.Artifact(manifest,
                                                          src.tensors))
    assert not (tmp_path / "port.tmp").exists()
    back = JA.load_artifact(out)
    for k, v in src.tensors.items():
        assert back.tensors[k].dtype == v.dtype
        np.testing.assert_array_equal(back.tensors[k], v)
    assert back.manifest["layers"] == src.manifest["layers"]
    assert back.manifest["tensors_sha256"] != ""
    x = jnp.asarray(arts["calib"][:64])
    np.testing.assert_array_equal(
        np.asarray(JA.load_artifact(arts["dirs"][res]).to_chain()(x)),
        np.asarray(back.to_chain(False)(x)))
    # written for the port's own platform: its recorded backends apply
    chain = TLM.AMMChain.load(out, device="cpu")
    assert chain.backends == tuple(r["backend"] for r in manifest["layers"])


def _lm_halves(seed=0):
    """Two tiny amm_lm artifacts (int8 target, int4 draft) of random
    tables for the reduced qwen3-14b config, packed by the port."""
    cfg = get_config("qwen3-14b", reduced=True)
    gen = torch.Generator().manual_seed(seed)
    t_layers, d_layers = [], []
    for _ in range(cfg.num_layers):
        p = {k: v.numpy() for k, v in init_amm_mlp_params(cfg, gen).items()}
        t_layers.append(p)
        d_layers.append({k: (v >> 4 if k.startswith("lut_") and v.dtype == np.int8
                             else v) for k, v in p.items()})
    return (pack_amm_lm(t_layers, cfg, "int8", name="t"),
            pack_amm_lm(d_layers, cfg, "int4", name="d"), cfg)


def test_bundles_load_across_packages(tmp_path):
    target, draft, cfg = _lm_halves()
    meta = {"name": "tiny-spec", "arch": cfg.name,
            "num_layers": cfg.num_layers, "spec_k": 3}
    # port writes, JAX reads
    TA.save_bundle(tmp_path / "port", meta, target, draft)
    jt, jd, jm = JA.load_bundle(tmp_path / "port")
    assert jm["spec_k"] == 3 and jm["kind"] == "bundle"
    assert jd.manifest["int4_cols"] == draft.manifest["int4_cols"]
    for half, got in ((target, jt), (draft, jd)):
        for k, v in half.tensors.items():
            np.testing.assert_array_equal(got.tensors[k], v)
    # JAX writes, the port reads
    JA.save_bundle(tmp_path / "jax", meta,
                   JA.Artifact(dict(jt.manifest), dict(jt.tensors)),
                   JA.Artifact(dict(jd.manifest), dict(jd.tensors)))
    pt, pd, pm = TA.load_bundle(tmp_path / "jax")
    assert pm == JA.peek_manifest(tmp_path / "jax")
    _assert_same_artifact(pt, jt)
    _assert_same_artifact(pd, jd)
    # int4 tables unpack to the int8 codes they were packed from
    dp = pd.lm_layer_params(device="cpu")
    assert dp[0]["lut_gate"].dtype == torch.int8
    assert int(dp[0]["lut_gate"].min()) >= -8 and int(dp[0]["lut_gate"].max()) <= 7


# ---------------------------------------------------------------------------
# every ArtifactError of the JAX reader, on the same directory
# ---------------------------------------------------------------------------


def _edit_manifest(path, **changes):
    mf = path / "manifest.json"
    m = json.loads(mf.read_text())
    for k, v in changes.items():
        if v is None:
            m.pop(k, None)
        else:
            m[k] = v
    mf.write_text(json.dumps(m))


def _drop_tensor(path, key):
    with np.load(path / "tensors.npz") as data:
        tensors = {k: data[k] for k in data.files if k != key}
    np.savez_compressed(path / "tensors.npz", **tensors)
    _edit_manifest(path, tensors_sha256=TA._sha256(path / "tensors.npz"))


def _layer_cols(path, delta):
    m = json.loads((path / "manifest.json").read_text())
    m["layers"][0]["cols"] += delta
    (path / "manifest.json").write_text(json.dumps(m))


def _bundle_record(path, key, **changes):
    m = json.loads((path / "manifest.json").read_text())
    m[key] = dict(m[key], **changes)
    (path / "manifest.json").write_text(json.dumps(m))


# case → (what is corrupted: "chain" or "bundle", the mutation, the loader,
# a pattern both packages' messages must match)
ERROR_CASES = {
    "no_manifest": ("chain", lambda p: (p / "manifest.json").unlink(),
                    "load_artifact", "no manifest.json"),
    "corrupt_manifest": ("chain",
                         lambda p: (p / "manifest.json").write_text("{not"),
                         "load_artifact", "corrupt manifest"),
    "bad_format": ("chain", lambda p: _edit_manifest(p, format="other"),
                   "load_artifact", "not a repro-lutmu-artifact"),
    "version": ("chain", lambda p: _edit_manifest(p, version=2),
                "load_artifact", "artifact version 2"),
    "missing_tensor_file": ("chain", lambda p: (p / "tensors.npz").unlink(),
                            "load_artifact", "missing tensor file"),
    "checksum": ("chain",
                 lambda p: open(p / "tensors.npz", "ab").write(b"\0junk"),
                 "load_artifact", "checksum mismatch"),
    "missing_tensor": ("chain", lambda p: _drop_tensor(p, "layer1/lut"),
                       "load_artifact", "layer1/lut missing"),
    "missing_keep_idx": ("chain", lambda p: _drop_tensor(p, "layer0/keep_idx"),
                         "load_artifact", "layer0/keep_idx missing"),
    "lut_shape": ("chain", lambda p: _layer_cols(p, 1), "load_artifact",
                  "LUT shape"),
    "unknown_kind": ("chain", lambda p: _edit_manifest(p, kind="weird"),
                     "load_artifact", "unknown artifact kind"),
    "bundle_to_load_artifact": ("bundle", lambda p: None, "load_artifact",
                                "is a target\\+draft bundle"),
    "not_a_bundle": ("chain", lambda p: None, "load_bundle", "not a bundle"),
    "bundle_version": ("bundle", lambda p: _edit_manifest(p, version=3),
                       "load_bundle", "bundle version 3"),
    "bundle_missing_record": ("bundle", lambda p: _edit_manifest(p, draft=None),
                              "load_bundle", "lacks a 'draft' record"),
    "bundle_checksum_drift": ("bundle", lambda p: _bundle_record(
        p, "target", tensors_sha256="0" * 64), "load_bundle", "drifted"),
    "bundle_half_corrupt": ("bundle", lambda p: open(
        p / "draft" / "tensors.npz", "ab").write(b"\0junk"), "load_bundle",
        "checksum mismatch"),
    "bundle_halves_disagree": ("bundle", lambda p: _edit_manifest(
        p / "draft", num_layers=5), "load_bundle",
        "halves disagree on num_layers"),
}


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    target, draft, cfg = _lm_halves(seed=1)
    path = tmp_path_factory.mktemp("torch_bundle") / "bundle"
    TA.save_bundle(path, {"arch": cfg.name, "num_layers": cfg.num_layers},
                   target, draft)
    return path


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_artifact_errors_match_jax(arts, bundle_dir, tmp_path, case):
    kind, mutate, loader, pattern = ERROR_CASES[case]
    src = arts["dirs"]["int8"] if kind == "chain" else bundle_dir
    path = tmp_path / "victim"
    shutil.copytree(src, path)
    mutate(path)
    with pytest.raises(JA.ArtifactError, match=pattern) as jerr:
        getattr(JA, loader)(path)
    with pytest.raises(TA.ArtifactError, match=pattern) as terr:
        getattr(TA, loader)(path)
    assert issubclass(TA.ArtifactError, ValueError)
    if case != "bundle_to_load_artifact":  # that message names each API
        assert str(terr.value) == str(jerr.value)


def test_gelu_chain_is_the_tanh_approximation(arts):
    """``"gelu"`` between stages is ``jax.nn.gelu``'s default, the tanh
    approximation: on JAX's layer-0 output the port's activation agrees
    with it to float32 rounding and not with the exact erf form; layer 1
    then matches bit for bit on that shared input (int8)."""
    port = TLM.AMMChain.load(arts["gelu"], device="cpu")
    ref = JLM.AMMChain.load(arts["gelu"])
    assert port.activation_names == ("gelu",)
    x = arts["calib"][:128]
    y0 = np.array(ref.layers[0](jnp.asarray(x)))
    want = np.asarray(jax.nn.gelu(jnp.asarray(y0)))
    got = TLM.AMMChain._ACTS["gelu"](torch.from_numpy(y0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(y0)).numpy()
    assert np.abs(exact - want).max() > 1e-4
    ins, outs = _layer_io(ref, x)
    np.testing.assert_array_equal(ins[1], want)
    np.testing.assert_array_equal(_port_layer(port, 1, ins[1]), outs[1])

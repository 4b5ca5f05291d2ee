"""The port's ``QualityProbe`` and its model pieces against the JAX package.

The JAX compiler builds an ``amm_lm`` artifact of the tiny config (2
layers, d_model 64) in the test; both packages serve it from disk with a
probe at rate 1.0 holding the dense reference weights.  Streams are the
same with the probe on and off, and the same in both packages.  The
probe's integer tallies equal JAX's: probes, tokens, lookups, saturation,
dead buckets and utilisation; the ``quality_rel_error`` histograms have
JAX's counts, and their sums agree within ``REL_SUM_RTOL`` (float32
matmuls of the dense reference, summed in another order).

``capture_mlp_inputs`` matches JAX's layer by layer on shared tokens.  The
tallies count codebook codes, and a code flips where an activation that
differs in its last bits straddles a threshold (ROADMAP C2): the codes are
compared from shared per-layer inputs, where both packages must agree,
and any flip between the two packages' own captures is named.

Full-sequence attention (``models/attention.py::attention``, and its
blockwise path at a small chunk) matches JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler import compile_lm_amm
from repro.compiler.artifact import load_artifact as jax_load_artifact
from repro.configs import get_config
from repro.core import lut_mu as JLU
from repro.core import maddness as JM
from repro.models import amm_mlp as JAMM
from repro.models import attention as JA
from repro.models import model as JMD
from repro.serving import QualityProbe as JQualityProbe
from repro.serving import Recorder as JRecorder
from repro.serving import load_engine as jax_load_engine
from repro_torch.compiler import load_artifact
from repro_torch.convert import config_from_jax, params_from_jax
from repro_torch.core import lut_mu as LU
from repro_torch.core import maddness as M
from repro_torch.models import amm_mlp as AMM
from repro_torch.models import attention as A
from repro_torch.models import model as MD
from repro_torch.serving import (MetricsRegistry, QualityProbe, Recorder,
                                 ServeEngine, load_engine)

PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 2], [4, 4, 1, 1, 5, 6, 7],
           [3, 1], list(range(1, 21))]
KNOBS = dict(max_batch=2, max_len=64)
# the rel-error sums: ≈ 100 float32 ratios of norms of float32 products
REL_SUM_RTOL = 1e-6
ACT_TOL = 1e-5


def _tiny_cfg():
    cfg = get_config("qwen3-14b", reduced=True)
    return dataclasses.replace(cfg, num_layers=2, d_model=64, d_ff=128,
                               vocab_size=64, num_heads=2, num_kv_heads=1,
                               head_dim=32)


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    cfg = _tiny_cfg()
    params = JMD.init_params(cfg, jax.random.PRNGKey(0))
    calib = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    out = str(tmp_path_factory.mktemp("torch_quality") / "lm")
    compile_lm_amm(params, cfg, calib, out=out)
    jart = jax_load_artifact(out)
    jcfg = dataclasses.replace(cfg, amm=dataclasses.replace(
        cfg.amm, enabled=True, **jart.manifest["amm"]))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return dict(path=out, cfg=cfg, params=params, tcfg=config_from_jax(cfg),
                tparams=tparams, jcfg=jcfg,
                jspliced=jart.splice_lm_params(params),
                tspliced=load_artifact(out).splice_lm_params(tparams,
                                                             device="cpu"),
                tjcfg=config_from_jax(jcfg))


def _streams(eng, prompts=PROMPTS):
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs]


def _port(art, rec=None):
    return load_engine(art["path"], art["tparams"], art["tcfg"], recorder=rec,
                       compute_dtype=torch.float32, device="cpu", **KNOBS)


def _quality_samples(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("quality_"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def test_probe_tallies_equal_jax(art):
    prompts = PROMPTS[2:5]  # the JAX probe replays op by op: kept short
    off = _streams(_port(art), prompts)
    rec = Recorder(trace=False)
    rec.quality = QualityProbe(rec.registry, rate=1.0,
                               dense_params=art["tparams"])
    assert _streams(_port(art, rec), prompts) == off
    jrec = JRecorder(trace=False)
    jrec.quality = JQualityProbe(jrec.registry, rate=1.0,
                                 dense_params=art["params"])
    want = _streams(jax_load_engine(art["path"], art["params"], art["cfg"],
                                    recorder=jrec, **KNOBS), prompts)
    assert off == want

    got = _quality_samples(rec.to_prometheus())
    ref = _quality_samples(jrec.to_prometheus())
    assert got.keys() == ref.keys()
    for key, value in ref.items():
        if key.startswith("quality_rel_error_sum"):
            assert got[key] == pytest.approx(value, rel=REL_SUM_RTOL), key
        elif not key.startswith("quality_rel_error_bucket"):
            assert got[key] == value, key
    v = rec.registry.value
    assert v("quality_probes_total") == len(prompts)
    assert v("quality_probe_errors_total") == 0
    assert v("quality_lookups_total", layer="0", proj="gate") > 0
    rels = rec.registry.find("quality_rel_error")
    assert {dict(h.labels)["proj"] for h in rels} == {"gate", "up", "down"}
    snap, jsnap = rec.quality.snapshot(), jrec.quality.snapshot()
    assert snap["dense_reference"] is True and snap["supported"] is True
    for k in ("probes", "probe_tokens", "probe_errors", "saturation",
              "supported", "rate", "max_tokens"):
        assert snap[k] == jsnap[k], k
    for layer, entry in jsnap["layers"].items():
        assert snap["layers"][layer]["buckets"] == entry["buckets"]
        for proj, r in entry["rel_error"].items():
            assert snap["layers"][layer]["rel_error"][proj]["n"] == r["n"]


def test_probe_without_dense_reference_and_rate(art):
    rec = Recorder(trace=False)
    rec.quality = QualityProbe(rec.registry, rate=0.5)
    eng = _port(art, rec)
    for p in PROMPTS[:4]:
        eng.submit(p, max_new_tokens=4)
    eng.run_until_drained()
    v = rec.registry.value
    assert v("quality_probes_total") == 2
    assert v("quality_probe_errors_total") == 0
    assert rec.registry.find("quality_rel_error") == []
    assert rec.registry.find("quality_bucket_utilisation")
    assert rec.quality.snapshot()["dense_reference"] is False
    # a dense engine skips every probe with a reason instead of raising
    rec2 = Recorder(trace=False)
    rec2.quality = QualityProbe(rec2.registry, rate=1.0)
    dense = ServeEngine(art["tparams"], art["tcfg"], recorder=rec2,
                        compute_dtype=torch.float32, device="cpu", **KNOBS)
    dense.submit([1, 2, 3], max_new_tokens=4)
    dense.run_until_drained()
    assert rec2.registry.value("quality_probes_total") == 0
    assert rec2.registry.value("quality_probe_skipped_total",
                               reason="no_amm") == 1
    with pytest.raises(ValueError, match="rate"):
        QualityProbe(MetricsRegistry(), rate=0.0)


def test_capture_mlp_inputs_matches_jax(art):
    tokens = np.asarray([PROMPTS[5][:12], PROMPTS[3] + [1] * 5], np.int32)
    want = JMD.capture_mlp_inputs(art["jspliced"], jnp.asarray(tokens),
                                  art["jcfg"])
    got = MD.capture_mlp_inputs(art["tspliced"], tokens, art["tjcfg"])
    assert len(got) == len(want) == art["cfg"].num_layers
    for g, w in zip(got, want):
        assert g.shape == (2 * 12, art["cfg"].d_model)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ACT_TOL,
                                   rtol=ACT_TOL)
    # dense params too (the quality probe's family check reads none)
    dense = MD.capture_mlp_inputs(art["tparams"], tokens, art["tcfg"])
    jdense = JMD.capture_mlp_inputs(art["params"], jnp.asarray(tokens),
                                    art["cfg"])
    for g, w in zip(dense, jdense):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ACT_TOL,
                                   rtol=ACT_TOL)


def _taps(lut_mu, apply, lp, x, cfg):
    taps = []
    lut_mu.set_probe_tap(lambda **kw: taps.append(kw))
    try:
        apply(lp, x, cfg)
    finally:
        lut_mu.set_probe_tap(None)
    return {t["proj"]: t for t in taps}


def test_codes_from_shared_inputs_and_flips_named(art):
    """Each layer's up- and down-tree codes: equal in both packages from
    the same (JAX-captured) inputs; between each package's own capture,
    every flip is named and none is expected at this size."""
    tokens = np.asarray([list(range(1, 21))], np.int32)
    jin = JMD.capture_mlp_inputs(art["jspliced"], jnp.asarray(tokens),
                                 art["jcfg"])
    tin = MD.capture_mlp_inputs(art["tspliced"], tokens, art["tjcfg"])
    flips = []
    for layer in range(art["cfg"].num_layers):
        jlp = jax.tree.map(lambda a: a[layer],
                           art["jspliced"]["layers"]["amm_mlp"])
        tlp = MD.layer_params(art["tspliced"]["layers"]["amm_mlp"], layer)
        shared = np.asarray(jin[layer])[None]
        jt = _taps(JLU, JAMM.amm_mlp_apply, jlp, jnp.asarray(shared),
                   art["jcfg"])
        tt = _taps(LU, AMM.amm_mlp_apply, tlp, torch.tensor(shared),
                   art["tjcfg"])
        own = _taps(LU, AMM.amm_mlp_apply, tlp, tin[layer][None],
                    art["tjcfg"])
        for proj in ("up", "down"):
            jx = jt[proj]["x"]
            if proj == "down":  # the package: JAX's, shared with the port
                from repro.kernels import dispatch as JD
                jx = JD._to_split_values(jx, jt[proj]["params"], "package")
                from repro_torch.kernels import dispatch as TD
                tx = TD._to_split_values(torch.tensor(np.asarray(
                    jt[proj]["x"])), tt[proj]["params"], "package")
                ox = TD._to_split_values(own[proj]["x"], own[proj]["params"],
                                         "package")
            else:
                tx, ox = tt[proj]["x"], own[proj]["x"]
            jc = np.asarray(JM.encode(jx, jt[proj]["params"].tree))
            tc = M.encode(tx, tt[proj]["params"].tree).numpy()
            np.testing.assert_array_equal(tc, jc)
            oc = M.encode(ox, own[proj]["params"].tree).numpy()
            flips += [(layer, proj, int(r), int(c))
                      for r, c in zip(*np.nonzero(oc != jc))]
    assert flips == [], f"codes that flip (layer, tree, row, codebook): {flips}"


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("s,chunk", [(12, None), (23, 8)])
def test_full_sequence_attention_matches_jax(art, window, s, chunk):
    """``attention`` at a short sequence (the materialised path), and the
    blockwise path at a chunk smaller than the sequence."""
    cfg, tcfg = art["cfg"], art["tcfg"]
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[0], art["params"]["layers"]["attn"])
    tlp = MD.layer_params(art["tparams"]["layers"]["attn"], 0)
    pos = np.broadcast_to(np.arange(s), (2, s))
    if chunk is None:
        want = JA.attention(jlp, jnp.asarray(x), cfg, positions=jnp.asarray(pos),
                            window=window)
        got = A.attention(tlp, torch.from_numpy(x), tcfg,
                          positions=torch.from_numpy(pos.copy()),
                          window=window)
    else:
        q, k, v = JA._project_qkv(jlp, jnp.asarray(x), cfg, jnp.asarray(pos))
        qg = JA._grouped(q, cfg.num_kv_heads)
        want = JA._chunked_attention(qg, k, v, window, True, chunk=chunk)
        t = [torch.tensor(np.asarray(a)) for a in (qg, k, v)]
        got = A._chunked_attention(*t, window, True, chunk=chunk)
        full = A.attention(tlp, torch.from_numpy(x), tcfg,
                           positions=torch.from_numpy(pos.copy()),
                           window=window, chunked_threshold=s)
        direct = A.attention(tlp, torch.from_numpy(x), tcfg,
                             positions=torch.from_numpy(pos.copy()),
                             window=window)
        np.testing.assert_allclose(full.numpy(), direct.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_block_apply_refuses_unported_blocks(art):
    """A ``moe`` block (ROADMAP A10, refused until ported) now computes:
    one mixtral block (attention + MoE, reduced) equals JAX's
    ``_block_apply`` on the same params and input within 1e-5."""
    cfg = get_config("mixtral-8x7b", reduced=True)
    jlp = JMD._init_block(cfg, jax.random.PRNGKey(7), 0, jnp.float32)
    assert "moe" in jlp
    x = np.random.default_rng(8).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (2, 6))
    want = JMD._block_apply(cfg, jlp, jnp.asarray(x), jnp.asarray(pos), 8,
                            JMD._id, 0)
    got = MD._block_apply(config_from_jax(cfg),
                          params_from_jax(jax.tree.map(np.asarray, jlp),
                                          device="cpu"),
                          torch.from_numpy(x), torch.from_numpy(pos.copy()), 8,
                          0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    ssm = config_from_jax(get_config("mamba2-370m", reduced=True))
    with pytest.raises(ValueError, match="uniform attention"):
        MD.capture_mlp_inputs({}, np.zeros((1, 2), np.int32), ssm)

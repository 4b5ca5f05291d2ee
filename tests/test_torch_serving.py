"""The port's paged ``ServeEngine`` against the JAX engine, and the port's
host-side serving pieces.

The slice gate: on the golden setup (2 layers, d_model 64, 5 prompts,
``max_new=8``, ``page_size=16``, ``prefill_chunk=4``, int8 LUTs) the JAX
compiler builds an ``amm_lm`` artifact in the test, JAX splices it, and the
spliced params are carried across; the port's greedy streams must equal the
JAX ``ServeEngine``'s streams run live in the same test (not the checked-in
JSON, which is stale under the installed JAX's PRNG mode).

The artifact gates: ``amm_lm`` artifacts the JAX compiler writes at int8,
float32 and int4 are read from disk by the port's own ``load_engine`` (no
JAX-spliced params carried across), and its greedy streams equal those of
JAX's ``load_engine`` on the same directory; the splice checks and the
source errors are JAX's; the launcher serves an artifact and a bundle.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from repro.compiler import compile_lm_amm
from repro.compiler.artifact import load_artifact
from repro.configs import get_config
from repro.models import model as JMD
from repro.serving import load_engine as jax_load_engine
from repro.compiler.artifact import load_artifact as jax_load_artifact
from repro_torch.compiler import ArtifactError, pack_amm_lm, save_artifact
from repro_torch.compiler import load_artifact as port_load_artifact
from repro_torch.compiler import save_bundle
from repro_torch.configs import get_config as port_get_config
from repro_torch.convert import config_from_jax, params_from_jax
from repro_torch.launch import serve as port_serve
from repro_torch.models.amm_mlp import init_amm_mlp_params
from repro_torch.models.model import init_params as port_init_params
from repro_torch.serving import (PageError, SamplingParams, ServeEngine,
                                 load_engine)

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
    s = eng.submit([1], SamplingParams(temperature=0.7, seed=5),
                   max_new_tokens=3)
    assert len(s.result()) == 3 and s.status == "done"
    with pytest.raises(ValueError):
        eng.submit(list(range(70)))  # ≥ max_len
    with pytest.raises(ArtifactError, match="no manifest.json"):
        load_engine("some/artifact", None, None)
    assert issubclass(PageError, RuntimeError)


def test_cuda_requested_without_cuda_raises(golden):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _port_engine(golden, device="cuda")


# ---------------------------------------------------------------------------
# serving compiled artifacts from disk
# ---------------------------------------------------------------------------

ART_RESOLUTIONS = ("int8", "float32", "int4")


@pytest.fixture(scope="module")
def lm_arts(tmp_path_factory):
    """The golden setup's dense params and config, and one JAX-compiled
    ``amm_lm`` artifact per resolution config on disk."""
    cfg = get_config("qwen3-14b", reduced=True)
    cfg = dataclasses.replace(cfg, num_layers=2, d_model=64, d_ff=128,
                              vocab_size=64, num_heads=2, num_kv_heads=1,
                              head_dim=32)
    params = JMD.init_params(cfg, jax.random.PRNGKey(0))
    calib = np.random.default_rng(0).integers(0, 64, (4, 16))
    root = tmp_path_factory.mktemp("torch_lm_arts")
    dirs = {}
    for res in ART_RESOLUTIONS:
        compile_lm_amm(params, cfg, calib, out=str(root / res),
                       resolution=res)
        dirs[res] = root / res
    return dict(params=params, cfg=cfg, dirs=dirs,
                tparams=params_from_jax(jax.tree.map(np.asarray, params),
                                        device="cpu"),
                tcfg=config_from_jax(cfg))


def _port_opts(**overrides):
    return dict(KNOBS, compute_dtype=torch.float32, device="cpu", **overrides)


@pytest.mark.parametrize("res", ART_RESOLUTIONS)
def test_port_serves_jax_artifact_from_disk(lm_arts, res):
    """The port reads the artifact itself: streams equal live JAX's."""
    path = lm_arts["dirs"][res]
    want = _streams(jax_load_engine(path, lm_arts["params"], lm_arts["cfg"],
                                    **KNOBS))
    eng = load_engine(path, lm_arts["tparams"], lm_arts["tcfg"], **_port_opts())
    assert type(eng) is ServeEngine and eng.cfg.amm.enabled
    amm = eng.params["layers"]["amm_mlp"]
    assert "mlp" not in eng.params["layers"]
    assert amm["lut_gate"].dtype == (torch.float32 if res == "float32"
                                     else torch.int8)
    if res == "int4":
        assert int(amm["lut_gate"].min()) >= -8
        assert int(amm["lut_gate"].max()) <= 7
    got = _streams(eng)
    assert all(len(s) == MAX_NEW for s in got)
    assert got == want


def test_port_serves_loaded_artifact_object(lm_arts):
    """A loaded ``Artifact`` (the port's) as the source."""
    path = lm_arts["dirs"]["int8"]
    want = _streams(jax_load_engine(path, lm_arts["params"], lm_arts["cfg"],
                                    **KNOBS))
    art = port_load_artifact(path)
    got = _streams(load_engine(art, lm_arts["tparams"], lm_arts["tcfg"],
                               **_port_opts()))
    assert got == want


def _mismatch(art, what):
    if what == "arch":
        art.manifest["arch"] = "llama-7b"
    elif what == "num_layers":
        art.manifest["num_layers"] = 3
    elif what == "d_model":
        art.tensors["layer0/lut_down"] = art.tensors["layer0/lut_down"][..., :32]
    else:  # kind
        art.manifest["kind"] = "amm_chain"
    return art


@pytest.mark.parametrize("what", ["arch", "num_layers", "d_model", "kind"])
def test_artifact_mismatch_raises_as_jax(lm_arts, what):
    path = lm_arts["dirs"]["int8"]
    jart = _mismatch(jax_load_artifact(path), what)
    tart = _mismatch(port_load_artifact(path), what)
    with pytest.raises(ValueError) as jerr:
        jax_load_engine(jart, lm_arts["params"], lm_arts["cfg"], **KNOBS)
    with pytest.raises(ArtifactError) as terr:
        load_engine(tart, lm_arts["tparams"], lm_arts["tcfg"], **_port_opts())
    assert type(jerr.value).__name__ == "ArtifactError"
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("case", ["spec_amm_lm", "spec_none", "bad_type",
                                  "pair_of_three", "bad_engine"])
def test_load_engine_source_errors_match_jax(lm_arts, case):
    path = lm_arts["dirs"]["int8"]
    source, kw = {"spec_amm_lm": (path, dict(speculative=True)),
                  "spec_none": (None, dict(speculative=True)),
                  "bad_type": (42, {}),
                  "pair_of_three": ((1, 2, 3), {}),
                  "bad_engine": (None, dict(engine="slots"))}[case]
    with pytest.raises((ValueError, TypeError)) as jerr:
        jax_load_engine(source, lm_arts["params"], lm_arts["cfg"], **kw,
                        **KNOBS)
    with pytest.raises((ValueError, TypeError)) as terr:
        load_engine(source, lm_arts["tparams"], lm_arts["tcfg"], **kw,
                    **_port_opts())
    assert type(terr.value) is type(jerr.value)
    with pytest.raises(NotImplementedError, match="A10"):
        load_engine(path, lm_arts["tparams"], lm_arts["tcfg"], engine="fixed",
                    **_port_opts())


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def launcher_arts(tmp_path_factory):
    """An int8 ``amm_lm`` artifact and an int8/int4 bundle of random tables
    for the reduced qwen3-14b, written by the port."""
    cfg = port_get_config("qwen3-14b", reduced=True)
    gen = torch.Generator().manual_seed(3)
    layers = [{k: v.numpy() for k, v in init_amm_mlp_params(cfg, gen).items()}
              for _ in range(cfg.num_layers)]
    draft = [{k: (v >> 4 if k.startswith("lut_") and v.dtype == np.int8
                  else v) for k, v in d.items()} for d in layers]
    root = tmp_path_factory.mktemp("torch_launcher")
    save_artifact(root / "art", pack_amm_lm(layers, cfg, "int8"))
    save_bundle(root / "bundle", {"arch": cfg.name,
                                  "num_layers": cfg.num_layers, "spec_k": 2},
                pack_amm_lm(layers, cfg, "int8"),
                pack_amm_lm(draft, cfg, "int4"))
    return root


BASE_ARGS = ["--arch", "qwen3-14b", "--reduced", "--device", "cpu",
             "--requests", "2", "--max-new", "3"]


def _served(out: str, n: int):
    lines = re.findall(r"^  req \d+: .* → \[(.*)\]$", out, re.M)
    assert len(lines) == n, out
    return [[int(t) for t in line.split(", ")] for line in lines]


def test_launcher_serves_artifact_and_bundle(launcher_arts, capsys):
    port_serve.main(BASE_ARGS + ["--artifact", str(launcher_arts / "art")])
    art_streams = _served(capsys.readouterr().out, 2)
    assert all(len(s) == 3 for s in art_streams)
    # a bundle without --speculative serves its target half: the same
    # tables, the same streams
    port_serve.main(BASE_ARGS + ["--artifact", str(launcher_arts / "bundle"),
                                 "--no-prefix-cache"])
    assert _served(capsys.readouterr().out, 2) == art_streams
    port_serve.main(BASE_ARGS + ["--artifact", str(launcher_arts / "bundle"),
                                 "--speculative", "--verify-backend", "fused",
                                 "--engine", "paged"])
    out = capsys.readouterr().out
    assert "[spec] k=2 " in out and "acceptance=" in out
    assert _served(out, 2) == art_streams
    port_serve.main(BASE_ARGS + ["--artifact", str(launcher_arts / "bundle"),
                                 "--speculative", "--spec-k", "3"])
    assert "[spec] k=3 " in capsys.readouterr().out


@pytest.mark.parametrize("extra,message", [
    (["--mesh", "2x2"], "A11"),
    (["--engine", "fixed"], "A10"),
    (["--speculative", "--amm"], "drop --amm"),
    (["--speculative", "--artifact", "ART"], "needs a target\\+draft bundle"),
    (["--artifact", "MISSING"], "cannot read artifact"),
])
def test_launcher_exits_where_not_ported(launcher_arts, extra, message):
    extra = [str(launcher_arts / "art") if a == "ART" else
             str(launcher_arts / "missing") if a == "MISSING" else a
             for a in extra]
    with pytest.raises(SystemExit, match=message):
        port_serve.main(BASE_ARGS + extra)


def test_launcher_sampled_flags_raise_until_a8(launcher_arts, capsys):
    """Sampling is ported (ROADMAP A8, named in this test's name from when
    the flags raised): the launcher's sampled streams are the same in two
    runs and equal ``ServeEngine``'s driven directly with the launcher's
    params, prompts and seeds (request ``i`` seeded ``--seed`` + i)."""
    args = BASE_ARGS + ["--artifact", str(launcher_arts / "art"),
                        "--temperature", "0.7", "--top-k", "8", "--seed", "3"]
    port_serve.main(args)
    first = _served(capsys.readouterr().out, 2)
    port_serve.main(args)
    assert _served(capsys.readouterr().out, 2) == first
    cfg = port_get_config("qwen3-14b", reduced=True)
    params = port_init_params(cfg, torch.Generator().manual_seed(0),
                              torch.float32)
    eng = load_engine(str(launcher_arts / "art"), params, cfg, max_batch=2,
                      max_len=128, page_size=16, prefill_chunk=32,
                      compute_dtype=torch.float32, device="cpu")
    hs = [eng.submit(p, SamplingParams(temperature=0.7, top_k=8, seed=3 + i),
                     max_new_tokens=3)
          for i, p in enumerate(port_serve.cli_prompts(None, 2,
                                                       cfg.vocab_size))]
    eng.run_until_drained()
    assert [h.generated for h in hs] == first
    port_serve.main(BASE_ARGS + ["--artifact", str(launcher_arts / "art")])
    assert _served(capsys.readouterr().out, 2) != first  # greedy differs

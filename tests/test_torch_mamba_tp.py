"""Tensor parallelism inside the port's Mamba block, in one process on the
CPU (the gloo meshes are in ``test_torch_mesh_serving.py`` and
``test_torch_mesh_train.py``).

* The block's stages chained over simulated ranks
  (``mamba_forward_split`` / ``mamba_decode_split``, the collectives as
  concatenations and sums in rank order) at tp 1, 2 and 4 on reduced
  mamba2-370m and reduced jamba, float32, from each rank's part-wise
  shards (``shard_params`` on an abstract ``1 × tp`` mesh), against the
  single-device ``mamba_forward`` / ``mamba_decode_step`` (which
  ``test_torch_families.py`` holds to JAX): the outputs, the SSM state and
  the conv window.  tp 1 is bitwise; above it within ``TP_REL`` of the
  largest magnitude.
* The part-wise cut and its gather (``take_shard`` with ``leaf_parts``,
  ``join_parts``) round-trip bitwise for ``in_proj``, ``conv_w``,
  ``conv_b`` and the cache's conv window, and each shard holds its heads'
  z, x and dt columns and its slice of B and of C.
* The guard (``mamba_tp_ok``): full-width mamba2-370m and jamba pass up
  to tp 16, the reduced configs up to tp 8; reduced width at tp 16 (8
  heads) falls back to the whole block: contiguous shards, the weights
  gathered at use, the cache's Mamba leaves by their slots only.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis.cost import ShapeComm
from repro_torch.configs import get_config
from repro_torch.device import MetaGenerator
from repro_torch.distributed import sharding as SH
from repro_torch.models import mamba as MB
from repro_torch.models import model as MD

ARCHS = ("mamba2-370m", "jamba-1.5-large-398b")
# float32: tp > 1 regroups three sums (the norm's mean of squares over the
# ranks' channels, the out projection's rows over the ranks, and BLAS's
# blocking of the narrower products), each a reassociation of at most
# d_inner = 256 terms: ≤ 256 · 2^-24 ≈ 1.5e-5 of the sum of magnitudes in
# the worst case, ~1e-6 seen; the states' per-head sums regroup only in
# BLAS
TP_REL = 2e-5


def _cfg(arch):
    return get_config(arch, reduced=True)


def _layer(cfg, seed=0):
    """A Mamba layer's params with non-zero norm, bias and conv-bias
    vectors (so a misplaced slice shows)."""
    gen = torch.Generator().manual_seed(seed)
    lp = MB.init_mamba_params(cfg, gen)
    rng = np.random.default_rng(seed)
    for k in ("norm_w", "dt_bias", "conv_b", "d_skip"):
        lp[k] = lp[k] + torch.from_numpy(
            rng.normal(scale=0.1, size=tuple(lp[k].shape)).astype(np.float32))
    return lp


def _mesh(tp):
    return SH.AbstractMesh((1, tp), ("data", "model"))


def _shards(lp, cfg, tp):
    mesh = _mesh(tp)
    return [SH.shard_params({"mamba": lp}, cfg, mesh,
                            {"data": 0, "model": r})["mamba"]
            for r in range(tp)]


def _close(got, want, tp):
    if tp == 1:
        assert torch.equal(got, want)
        return
    err = float((got - want).abs().max())
    assert err <= TP_REL * float(want.abs().max()), err


def _whole_state(states, cfg, tp):
    conv = SH.join_parts(torch.cat([s["conv"] for s in states], -1), 2,
                         SH.mamba_parts(cfg, "mamba/conv"), tp)
    return {"conv": conv, "ssm": torch.cat([s["ssm"] for s in states], 1)}


@pytest.mark.parametrize("tp", (1, 2, 4))
@pytest.mark.parametrize("arch", ARCHS)
def test_stages_over_simulated_ranks(arch, tp):
    cfg = _cfg(arch)
    assert SH.mamba_tp_ok(cfg, tp)
    lp = _layer(cfg)
    shards = _shards(lp, cfg, tp)
    rng = np.random.default_rng(1)
    for s in (37, 2):  # not a chunk multiple; shorter than the conv window
        x = torch.from_numpy(rng.normal(size=(2, s, cfg.d_model)).astype(
            np.float32))
        want, wstate = MB.mamba_forward(lp, x, cfg, return_state=True)
        got, states = MB.mamba_forward_split(shards, x, cfg,
                                             return_state=True)
        _close(got, want, tp)
        di, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
        nh = di // cfg.ssm_headdim
        for st in states:  # each rank holds its heads and channels
            assert tuple(st["ssm"].shape) == (2, nh // tp, cfg.ssm_state,
                                              cfg.ssm_headdim)
            assert st["conv"].shape[-1] == (di + 2 * gn) // tp
        whole = _whole_state(states, cfg, tp)
        for k in ("conv", "ssm"):
            _close(whole[k], wstate[k], tp)
    # three decode steps from the prefill's state, each rank's cache its
    # part-wise cut of the whole one
    cache = {k: v.clone() for k, v in wstate.items()}
    caches = [{"conv": SH.take_shard(wstate["conv"], (None, None, "model"),
                                     _mesh(tp), {"data": 0, "model": r},
                                     SH.leaf_parts(cfg, _mesh(tp),
                                                   "mamba/conv")),
               "ssm": wstate["ssm"].chunk(tp, 1)[r].clone()}
              for r in range(tp)]
    for _ in range(3):
        xt = torch.from_numpy(rng.normal(size=(2, 1, cfg.d_model)).astype(
            np.float32))
        want = MB.mamba_decode_step(lp, xt, cfg, cache)
        got = MB.mamba_decode_split(shards, xt, cfg, caches)
        _close(got, want, tp)
    whole = _whole_state(caches, cfg, tp)
    for k in ("conv", "ssm"):
        _close(whole[k], cache[k], tp)


@pytest.mark.parametrize("tp", (2, 4))
def test_part_cut_round_trips(tp):
    cfg = _cfg("jamba-1.5-large-398b")
    mesh = _mesh(tp)
    gen = torch.Generator().manual_seed(2)
    di, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    nh = di // cfg.ssm_headdim
    conv_dim = di + 2 * gn
    leaves = {
        "layers/pos0/mamba/in_proj": (torch.randn(
            (2, cfg.d_model, 2 * di + 2 * gn + nh), generator=gen),
            (None, None, "model")),
        "layers/pos0/mamba/conv_w": (torch.randn((2, cfg.ssm_conv, conv_dim),
                                                 generator=gen),
                                     (None, None, "model")),
        "layers/pos0/mamba/conv_b": (torch.randn((2, conv_dim), generator=gen),
                                     (None, "model")),
        "pos0/mamba/conv": (torch.randn((2, 3, cfg.ssm_conv - 1, conv_dim),
                                        generator=gen),
                            (None, None, None, "model")),
    }
    for path, (t, spec) in leaves.items():
        parts = SH.leaf_parts(cfg, mesh, path)
        assert parts == SH.mamba_parts(cfg, path) and sum(parts) == t.shape[-1]
        shards = [SH.take_shard(t, spec, mesh, {"data": 0, "model": r}, parts)
                  for r in range(tp)]
        assert all(s.shape[-1] == t.shape[-1] // tp for s in shards)
        back = SH.join_parts(torch.cat(shards, -1), t.dim() - 1, parts, tp)
        assert torch.equal(back, t), path
        for r, s in enumerate(shards):  # part k: its r-th 1/tp, in order
            at, off = 0, 0
            for size in parts:
                step = size // tp
                assert torch.equal(s[..., off:off + step],
                                   t[..., at + r * step:at + (r + 1) * step])
                at, off = at + size, off + step
    # the one-layer cut the tests chain is the stacked leaf's layer
    params = MD.init_params(cfg, torch.Generator().manual_seed(3))
    lp = MD.layer_params(params["layers"]["pos0"], 1)["mamba"]
    for r in range(tp):
        coord = {"data": 0, "model": r}
        local = SH.shard_params(params, cfg, mesh, coord)
        one = SH.shard_params({"mamba": lp}, cfg, mesh, coord)["mamba"]
        got = MD.layer_params(local["layers"]["pos0"], 1)["mamba"]
        assert all(torch.equal(got[k], one[k]) for k in one)


def test_guard_and_fallback():
    for arch in ARCHS:
        full, red = get_config(arch), _cfg(arch)
        assert all(SH.mamba_tp_ok(full, tp) for tp in (1, 2, 4, 8, 16))
        assert all(SH.mamba_tp_ok(red, tp) for tp in (1, 2, 4, 8))
        assert not SH.mamba_tp_ok(red, 16)  # 8 heads
    assert not SH.mamba_tp_ok(get_config("qwen3-14b"), 1)  # no Mamba
    # reduced mamba2 on 1×16: the block whole, as before Mamba TP
    cfg = _cfg("mamba2-370m")
    mesh = _mesh(16)
    params = MD.init_params(cfg, MetaGenerator())
    par = SH.ParallelContext(cfg, mesh, params, ShapeComm(mesh))
    assert not par.mamba_tp and par.parts("layers/mamba/in_proj") is None
    assert SH.leaf_parts(cfg, mesh, "layers/mamba/in_proj") is None
    spec = par.specs["layers/mamba/conv_w"]
    assert spec[-1] == "model"  # JAX's rule cuts its 288 channels in 16
    assert par._keep_tp("mamba/conv_w", spec[1:]) == ()  # gathered at use
    assert not any("model" in SH._entry_axes(e)
                   for e in par.grad_sum_axes("layers/mamba/norm_w"))
    cache = MD.init_cache(cfg, 2, 32, device="meta")
    specs = par.place_cache(cache, 2)
    rule = SH.flatten(SH.cache_shardings(cache, cfg, mesh, 2))
    assert rule["mamba/conv"][-1] == "model"
    assert all("model" not in SH._entry_axes(e) for p in specs
               for e in specs[p])
    # a decode step on the meta device: the whole block on every rank
    local = SH.shard_params(params, cfg, mesh, {"data": 0, "model": 0})
    local_cache = SH.unflatten({p: SH.take_shard(t, specs[p], mesh,
                                                 {"data": 0, "model": 0})
                                for p, t in SH.flatten(cache).items()})
    logits = MD.decode_step(local, torch.zeros((2, 1), dtype=torch.int64,
                                               device="meta"),
                            torch.zeros((2,), dtype=torch.int64,
                                        device="meta"),
                            local_cache, cfg, par=par)
    assert tuple(logits.shape) == (2, 1, cfg.vocab_size)
    # the same config at tp 4: the block cut, the cache JAX's rule exactly
    mesh4 = _mesh(4)
    par4 = SH.ParallelContext(cfg, mesh4, params, ShapeComm(mesh4))
    assert par4.mamba_tp
    assert par4._keep_tp("mamba/in_proj",
                         par4.specs["layers/mamba/in_proj"][1:]) == (1,)
    assert ("model",) in par4.grad_sum_axes("layers/mamba/a_log")
    assert par4.place_cache(cache, 2) == SH.flatten(
        SH.cache_shardings(cache, cfg, mesh4, 2))

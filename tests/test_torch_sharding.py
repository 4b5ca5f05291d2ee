"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's (``repro.distributed.sharding``), spec by spec, in one
process.

For each of the ten configs, at reduced and at full width, dense and with
LUT-MU serving tables: the port's params made on the ``meta`` device
(shapes only) against ``jax.eval_shape`` of JAX's ``init_params``, on the
meshes 1×1, 1×2, 2×2, 2×4, 4×2, 16×16 and 2×16×16 as shapes (JAX's
``AbstractMesh``, the port's ``AbstractMesh``): every leaf's spec equals
JAX's ``param_shardings`` entry; ``shard_params`` gives the first and the
last rank a local shape equal to ``NamedSharding.shard_shape``; the
fixed-slot cache's specs (a batch the data degree divides, and one it
does not) equal ``cache_shardings``', the paged pool's (a page count that
divides, and one that does not) ``paged_cache_shardings``'.  JAX meshes
are abstract only: the installed JAX's ``make_mesh`` default of Explicit
axes is ROADMAP C3.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding

from repro.configs import ARCH_IDS, get_config
from repro.distributed import sharding as JSH
from repro.models import model as JMD
from repro_torch.convert import config_from_jax
from repro_torch.distributed import sharding as TSH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as TMD

MESHES = [((1, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
BATCHES = (32, 3)        # a batch every data degree divides, and one none does
PAGES = (64, 33)         # likewise for the paged pool's page axis
MAX_LEN = 256            # 16×16 divides it whole; 2×16×16's data axes only


class _MetaGen(torch.Generator):
    """A CPU generator that makes the port's init draw on ``meta``."""

    @property
    def device(self):
        return torch.device("meta")


def _cfg(arch: str, reduced: bool, serving: bool):
    cfg = get_config(arch, reduced=reduced)
    if serving:
        cfg = dataclasses.replace(cfg, amm=dataclasses.replace(cfg.amm,
                                                               enabled=True))
    return cfg


def _jax_flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))
    return {JSH._leaf_path(p): v for p, v in leaves}


def _meshes():
    for shape, names in MESHES:
        yield JAbstractMesh(shape, names), TSH.AbstractMesh(shape, names)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_local_shapes(arch, reduced):
    for serving in (False, True):
        cfg = _cfg(arch, reduced, serving)
        jshape = jax.eval_shape(
            lambda k: JMD.init_params(cfg, k, serving=serving),
            jax.random.PRNGKey(0))
        tparams = TMD.init_params(config_from_jax(cfg), _MetaGen(),
                                  serving=serving)
        tflat = TSH.flatten(tparams)
        jleaves = {JSH._leaf_path(p): v for p, v in
                   jax.tree_util.tree_flatten_with_path(jshape)[0]}
        assert tflat.keys() == jleaves.keys()
        assert all(tuple(tflat[k].shape) == tuple(jleaves[k].shape)
                   for k in tflat)
        for jmesh, tmesh in _meshes():
            jspecs = _jax_flat(JSH.param_shardings(jshape, cfg, jmesh))
            tspecs = TSH.flatten(TSH.param_shardings(tparams,
                                                     config_from_jax(cfg),
                                                     tmesh))
            for path, js in jspecs.items():
                assert tspecs[path] == tuple(js.spec), (arch, tmesh, path)
            # the first and the last rank's shards
            sizes = tmesh.shape
            for coord in ({a: 0 for a in sizes},
                          {a: n - 1 for a, n in sizes.items()}):
                local = TSH.flatten(TSH.shard_params(
                    tparams, config_from_jax(cfg), tmesh, coord))
                for path, js in jspecs.items():
                    want = js.shard_shape(tuple(jleaves[path].shape))
                    assert tuple(local[path].shape) == tuple(want), (
                        arch, tmesh, coord, path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs(arch):
    for reduced in (True, False):
        cfg = get_config(arch, reduced=reduced)
        tcfg = config_from_jax(cfg)
        for batch in BATCHES:
            jc = jax.eval_shape(lambda: JMD.init_cache(cfg, batch, MAX_LEN))
            tc = TMD.init_cache(tcfg, batch, MAX_LEN, device="meta")
            for jmesh, tmesh in _meshes():
                jspecs = _jax_flat(JSH.cache_shardings(jc, cfg, jmesh, batch))
                tspecs = TSH.flatten(TSH.cache_shardings(tc, tcfg, tmesh,
                                                         batch))
                assert tspecs.keys() == jspecs.keys()
                for path, js in jspecs.items():
                    assert tspecs[path] == tuple(js.spec), (
                        arch, batch, tmesh, path)
        if not TMD.supports_paged(tcfg):
            continue
        for pages in PAGES:
            jc = jax.eval_shape(lambda: JMD.init_paged_cache(cfg, pages, 16))
            tc = TMD.init_paged_cache(tcfg, pages, 16, device="meta")
            for jmesh, tmesh in _meshes():
                jspecs = _jax_flat(JSH.paged_cache_shardings(jc, cfg, jmesh))
                tspecs = TSH.flatten(TSH.paged_cache_shardings(tc, tcfg,
                                                               tmesh))
                for path, js in jspecs.items():
                    assert tspecs[path] == tuple(js.spec), (
                        arch, pages, tmesh, path)


def test_batch_spec_and_production_mesh():
    for (jmesh, tmesh), b in itertools.product(_meshes(), (1, 2, 3, 32, 512)):
        assert TSH.batch_spec(tmesh, b) == tuple(JSH.batch_spec(jmesh, b))
        assert TSH.MeshAxes.for_mesh(tmesh) == TSH.MeshAxes(
            **dataclasses.asdict(JSH.MeshAxes.for_mesh(jmesh)))
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi)
        assert m.shape_tuple == ((2, 16, 16) if multi else (16, 16))
        assert m.axis_names == (("pod", "data", "model") if multi
                                else ("data", "model"))


def test_expert_parallel_rule():
    """EP when the experts divide the model axis (qwen3-moe's 128 on 16),
    TP inside the expert otherwise (mixtral's 8 on 16)."""
    for arch, ep in (("qwen3-moe-30b-a3b", True), ("mixtral-8x7b", False)):
        cfg = get_config(arch)
        tmesh = TSH.AbstractMesh((16, 16), ("data", "model"))
        jmesh = JAbstractMesh((16, 16), ("data", "model"))
        axes = TSH.MeshAxes.for_mesh(tmesh)
        assert TSH.use_expert_parallel(config_from_jax(cfg), tmesh,
                                       axes) is ep
        assert JSH.use_expert_parallel(
            cfg, jmesh, JSH.MeshAxes.for_mesh(jmesh)) is ep


def test_take_shard_values():
    """A shard's values are the slice the spec names, rows of a multi-axis
    entry in row-major order over its axes."""
    mesh = TSH.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    spec = (("pod", "data"), "model")
    for pod, data, model in itertools.product(range(2), repeat=3):
        got = TSH.take_shard(t, spec, mesh,
                             {"pod": pod, "data": data, "model": model})
        r = pod * 2 + data
        assert torch.equal(got, t[2 * r:2 * r + 2, 3 * model:3 * model + 3])
    assert TSH.take_shard(t, (), mesh, {"pod": 0, "data": 0,
                                        "model": 0}) is t
    assert np.prod(TSH.local_shape((8, 6), spec, mesh)) == 6

"""The port's dry-run against the JAX package's, on the CPU: the shape
cells (``launch/shapes.py``), the ``meta``-device dry-run
(``launch/dryrun.py``, ``analysis/cost.py``) and the H100 roofline
(``analysis/roofline.py``).

* ``SHAPES``, ``LONG_CONTEXT_OK``, ``cell_is_applicable`` and
  ``input_specs`` (shapes and dtypes) equal JAX's on all 10 × 4 cells.
* ``python -m repro_torch.launch.dryrun --smoke`` exits 0: the ten reduced
  configs × (train_4k, decode_32k) at 64 tokens × batch 4 on an abstract
  2×4 mesh.
* Per-rank argument bytes of every full-width config's train_4k,
  prefill_32k and decode_32k cells on 16×16 and 2×16×16 equal the sum of
  ``NamedSharding.shard_shape`` bytes from ``jax.eval_shape`` and JAX's
  ``param_shardings`` / ``cache_shardings`` / ``batch_spec`` on an
  ``AbstractMesh`` (``rule_argument_size_bytes``), and so do the port's
  own: a prefill computes its data rank's rows, and every decode cache
  leaf holds exactly JAX's shard, Mamba's SSM state and conv window
  included (their heads and channels cut over ``model``).  No JAX mesh of
  devices is built (ROADMAP C3).
* At 1×1 the dry-run's FLOPs equal ``FlopCounterMode`` over the plain
  single-device step, and equal the count stated from the code: every
  layer's products four times (forward, remat recompute, two backward
  products) but its last (``w_down``: the non-reentrant checkpoint stops
  recomputing once every saved tensor is back) three times, the head's
  three times; ``model_flops / flops`` sits near 6/8, moved by those
  and by the embedding's share of N.
* ``roofline_terms`` with the constants set to JAX's equals JAX's
  ``roofline_terms`` on the same record, and reads the records a run
  wrote.
"""
import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis import roofline as JRF
from repro.configs import ARCH_IDS, get_config
from repro.distributed import sharding as JSH
from repro.launch import shapes as JSHAPES
from repro.models import model as JMD
from repro.runtime import steps as JST
from repro_torch import pytree as T
from repro_torch.analysis import cost as COST
from repro_torch.analysis import roofline as TRF
from repro_torch.convert import config_from_jax
from repro_torch.device import MetaGenerator
from repro_torch.distributed import sharding as TSH
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.launch import dryrun as DR
from repro_torch.launch import shapes as TSHAPES
from repro_torch.models import model as TMD
from repro_torch.optim import cosine_schedule
from repro_torch.runtime import steps as TST

ROOT = Path(__file__).resolve().parents[1]
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_cells_equal_jax(arch):
    assert TSHAPES.LONG_CONTEXT_OK == JSHAPES.LONG_CONTEXT_OK
    assert list(TSHAPES.SHAPES) == list(JSHAPES.SHAPES)
    jcfg = get_config(arch)
    tcfg = config_from_jax(jcfg)
    for name, jcell in JSHAPES.SHAPES.items():
        tcell = TSHAPES.SHAPES[name]
        assert dataclasses.astuple(tcell) == dataclasses.astuple(jcell)
        assert (TSHAPES.cell_is_applicable(arch, name)
                == JSHAPES.cell_is_applicable(arch, name))
        want = JSHAPES.input_specs(jcfg, jcell)
        got = TSHAPES.input_specs(tcfg, tcell)
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(v.shape), (name, k)
            assert _dtype(got[k].dtype) == str(v.dtype), (name, k)


def test_dryrun_smoke_cli():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count(": OK\n") >= 2 * len(ARCH_IDS)
    assert "FAIL" not in proc.stdout


def _jax_bytes(shape_tree, sharding_tree, itemsizes=None) -> int:
    """The bytes of a rank's shards (``NamedSharding.shard_shape``), at
    each leaf's own item size or at ``itemsizes`` (in flatten order)."""
    shapes = jax.tree.leaves(shape_tree)
    shardings = jax.tree.leaves(
        sharding_tree, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(shapes) == len(shardings)
    if itemsizes is None:
        itemsizes = [a.dtype.itemsize for a in shapes]
    return sum(math.prod(s.shard_shape(tuple(a.shape))) * n
               for a, s, n in zip(shapes, shardings, itemsizes))


def _jax_leaf_bytes(shape_tree, sharding_tree) -> dict:
    """Path → the bytes of a rank's shard of each leaf."""
    shapes = jax.tree_util.tree_flatten_with_path(shape_tree)[0]
    shardings = jax.tree.leaves(
        sharding_tree, is_leaf=lambda x: isinstance(x, NamedSharding))
    return {JSH._leaf_path(p): math.prod(s.shard_shape(tuple(a.shape)))
            * a.dtype.itemsize for (p, a), s in zip(shapes, shardings)}


def _jax_input_bytes(specs, jmesh) -> int:
    return sum(math.prod(NamedSharding(jmesh, P(*(
        JSH.batch_spec(jmesh, v.shape[0]) if v.ndim else ()))).shard_shape(
            tuple(v.shape))) * v.dtype.itemsize for v in specs.values())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_equal_jax_rules(arch):
    jcfg = get_config(arch)
    tcfg = config_from_jax(jcfg)
    key = jax.random.PRNGKey(0)
    jstate = jax.eval_shape(lambda k: JST.init_train_state(jcfg, k), key)
    jparams = jax.eval_shape(
        lambda k: JMD.init_params(jcfg, k, jax.numpy.bfloat16, serving=True),
        key)
    sizes = [t.element_size() for t in T.leaves(TMD.init_params(
        tcfg, MetaGenerator(), torch.bfloat16, serving=True))]
    dcell = JSHAPES.SHAPES["decode_32k"]
    jcache = jax.eval_shape(lambda: JMD.init_cache(
        jcfg, dcell.global_batch, dcell.seq_len, jax.numpy.bfloat16))
    for shape, names in MESHES:
        jmesh, tmesh = JAbstractMesh(shape, names), AbstractMesh(shape, names)
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            jcell, tcell = JSHAPES.SHAPES[name], TSHAPES.SHAPES[name]
            inputs = _jax_input_bytes(JSHAPES.input_specs(jcfg, jcell), jmesh)
            got = DR.cell_arguments(tcfg, tcell, tmesh,
                                    COST.ShapeComm(tmesh))
            held = got["arguments"]
            assert held["inputs"] == inputs, (arch, name, shape)
            if name == "train_4k":
                state = sum(_jax_bytes(t, JSH.param_shardings(t, jcfg, jmesh))
                            for t in (jstate.params, jstate.opt.mu,
                                      jstate.opt.nu)) + 2 * 4  # two steps
                assert held["state"] == state, (arch, shape)
                assert got["rule"] == state + inputs
                continue
            # JAX's dense_init multiplies by a numpy float64 scale, which
            # promotes its bf16 draws to float32 (ROADMAP C10): its shard
            # shapes at the port's bf16 item sizes
            params = _jax_bytes(jparams, JSH.param_shardings(jparams, jcfg,
                                                             jmesh), sizes)
            assert held["params"] == params, (arch, shape)
            if name == "prefill_32k":  # the rank's rows by batch_spec
                assert got["rule"] == params + inputs, (arch, shape)
                continue
            cache = _jax_leaf_bytes(jcache, JSH.cache_shardings(
                jcache, jcfg, jmesh, dcell.global_batch))
            assert got["rule"] == params + sum(cache.values()) + inputs, (
                arch, shape)
            local = {p: COST.nbytes(t)
                     for p, t in TSH.flatten(got["args"][3]).items()}
            assert set(local) == set(cache)
            assert held["cache"] == sum(local.values())
            for p, n in local.items():
                assert n == cache[p], (arch, shape, p)
            assert got["rule"] == sum(held.values()), (arch, shape)


def _small_cell(kind="train"):
    return TSHAPES.ShapeCell("train_4k", 64, 4, kind)


def test_flops_at_1x1_equal_plain_step_and_the_count_from_the_code():
    jcfg = dataclasses.replace(get_config("qwen3-14b", reduced=True),
                               grad_accum=2)
    cfg = config_from_jax(jcfg)
    cell = _small_cell()
    rec = DR.run_cell("qwen3-14b", "train_4k", multi_pod=False,
                      cfg_override=cfg,
                      mesh_override=AbstractMesh((1, 1), ("data", "model")),
                      cell_override=cell, save=False, force=True)
    assert rec["status"] == "ok" and rec["collectives"]["total_bytes"] == 0
    state = TST.init_train_state(cfg, MetaGenerator())
    step = TST.make_train_step(cfg, cosine_schedule(3e-4, 100, 10000))
    with FlopCounterMode(display=False) as fc:
        step(state, TSHAPES.input_specs(cfg, cell))
    assert rec["flops_per_device"] == fc.get_total_flops()
    # from the code: each layer's products (q, k, v, o, gate, up and the
    # two attention einsums) run 4x (forward, remat recompute, two backward
    # products each); w_down 3x (the recompute stops before it: nothing
    # saves its output), the head 3x (no remat)
    d, s, b = cfg.d_model, cell.seq_len, cell.global_batch
    hd, nq, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    tokens = b * s
    per_layer = (2 * tokens * d * hd * (2 * nq + 2 * nkv)
                 + 2 * tokens * 2 * d * cfg.d_ff
                 + 2 * 2 * b * nq * s * s * hd)
    down = 2 * tokens * d * cfg.d_ff
    head = 2 * tokens * d * cfg.vocab_size
    assert rec["flops_per_device"] == (
        cfg.num_layers * (4 * per_layer + 3 * down) + 3 * head)
    useful = TRF.model_flops(rec) / rec["flops_per_device"]
    # 6/8 per product, raised by the skipped w_down recompute and by the
    # embedding's share of N (6·N counts it, it has no product), lowered by
    # the attention einsums (no params): 0.806 here
    assert 0.7 < useful < 0.85, useful
    mem = rec["memory_analysis"]
    assert mem["argument_size_bytes"] == COST.tree_bytes(state) + 2 * 4 * b * s
    assert mem["temp_size_bytes"] > 0 and rec["bytes_per_device"] > 0


def test_roofline_equals_jax_with_jax_constants(monkeypatch, tmp_path):
    cfg = config_from_jax(get_config("mixtral-8x7b", reduced=True))
    rec = DR.run_cell("mixtral-8x7b", "train_4k", multi_pod=False,
                      cfg_override=cfg,
                      mesh_override=AbstractMesh((2, 2), ("data", "model")),
                      cell_override=_small_cell(), save=False, force=True)
    assert rec["collectives"]["total_bytes"] > 0
    for kind in ("all-gather", "all-reduce", "reduce-scatter"):
        assert rec["collectives"][kind]["count"] > 0, kind
    monkeypatch.setattr(TRF, "PEAK_FLOPS", JRF.PEAK_FLOPS)
    monkeypatch.setattr(TRF, "HBM_BW", JRF.HBM_BW)
    monkeypatch.setattr(TRF, "LINK_BW", JRF.ICI_BW)
    assert TRF.roofline_terms(rec) == JRF.roofline_terms(rec)
    monkeypatch.undo()
    assert (TRF.PEAK_FLOPS, TRF.HBM_BW, TRF.LINK_BW) == (989e12, 3.35e12,
                                                          450e9)
    import json
    (tmp_path / "a.json").write_text(json.dumps(rec))
    (tmp_path / "b.json").write_text(json.dumps(
        {"arch": "x", "shape": "long_500k", "mesh": "2x2",
         "status": "skipped", "reason": "why"}))
    monkeypatch.setattr(TRF, "RESULTS_DIR", tmp_path)
    rows = TRF.load_all()
    assert rows[0] == TRF.roofline_terms(rec) and rows[1]["skipped"]
    table = TRF.format_table(rows)
    assert "mixtral-8x7b" in table and "skipped: why" in table

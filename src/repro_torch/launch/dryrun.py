"""Dry-run of every (arch × shape × mesh) cell on the ``meta`` device, as
``repro.launch.dryrun`` proves its cells by lowering and compiling them on
512 faked devices.

No device and no process group: for each cell this

  1. describes the production mesh (16×16 single-pod / 2×16×16 multi-pod)
     as an ``AbstractMesh``;
  2. builds the cell's state on ``meta`` (``init_train_state`` for train;
     the serving params, and the fixed-slot cache for decode) and cuts rank
     (0, …, 0)'s shards by the rule engine (``distributed/sharding.py``;
     the rules' guards keep the ranks symmetric);
  3. runs that rank's step (the sharded train step with its backward and
     remat recompute, ``prefill`` or ``decode_step``) under a
     ``ParallelContext`` whose communicator is ``analysis.cost.ShapeComm``;
  4. records, per rank, the FLOPs, the op bytes, the LUT ops, the
     collectives, the argument, output and temporary bytes
     (``analysis/cost.py``), in the JAX record's field names, so
     ``analysis/roofline.py`` reads either package's JSON.

``memory_analysis.argument_size_bytes`` is exact: the bytes of the shards
the rank holds (train state or params and cache) and of the input rows it
computes (``batch_spec``: a prefill or train step computes its data
rank's rows).  ``rule_argument_size_bytes`` is the same sum under JAX's
placement (params and state by ``param_shardings``, the cache by
``cache_shardings``, inputs by ``batch_spec``); the two are equal for
every config: the Mamba state's heads and conv channels are cut over
``model`` as JAX cuts them (``ParallelContext.place_cache``), and the
Mamba block computes its rank's share.  Only where a config's Mamba parts
do not divide tp (``mamba_tp_ok``; none of the 16×16 cells) does the
port keep the Mamba state whole over ``model``, and hold more.
``temp_size_bytes`` is the peak of the bytes the step allocates beyond
its arguments; ``output_size_bytes`` the bytes of what it
returns (and, for decode, the cache it updates in place, which the JAX step
returns).

Results are cached as JSON under ``dryrun_results_torch/``.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-27b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--force] [--amm]
  python -m repro_torch.launch.dryrun --smoke   # reduced configs, 2x4 mesh
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis.cost import (ShapeComm, run_counted,
                                       tree_bytes)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import MetaGenerator
from repro_torch.distributed.sharding import (AbstractMesh, ParallelContext,
                                              batch_spec, cache_shardings,
                                              flatten, local_shape,
                                              shard_params, shard_state,
                                              take_shard, unflatten)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import (SHAPES, ShapeCell, cell_is_applicable,
                                       input_specs)
from repro_torch.models import model as MD
from repro_torch.optim import cosine_schedule
from repro_torch.runtime.steps import (init_train_state, make_decode_step,
                                       make_prefill_step, make_train_step)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_results_torch"


def _mesh_tag(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape_tuple)


def _cell_path(arch: str, shape: str, multi_pod: bool, amm: bool) -> Path:
    tag = ("2x16x16" if multi_pod else "16x16") + ("__amm" if amm else "")
    return RESULTS_DIR / f"{arch}__{shape}__{tag}.json"


def _with_amm(cfg):
    return dataclasses.replace(
        cfg, amm=dataclasses.replace(cfg.amm, enabled=True))


def _shard_bytes(tree, specs, mesh) -> int:
    """The bytes of a rank's shards of ``tree`` placed by the flat
    ``specs`` (path → spec)."""
    return sum(math.prod(local_shape(t.shape, specs[p], mesh))
               * t.element_size() for p, t in flatten(tree).items())


def _input_bytes(inputs: dict, mesh) -> int:
    """The bytes of the inputs' rows a rank holds under ``batch_spec``."""
    return sum(math.prod(local_shape(
        t.shape, batch_spec(mesh, t.shape[0]) if t.dim() else (), mesh))
        * t.element_size() for t in inputs.values())


def _prefill_len(cfg, cell: ShapeCell) -> int:
    """The prefill cache length: the sequence, a VLM's patches and a margin,
    rounded up to 512 so its seq axis stays tp-shardable (JAX's rule)."""
    extra = cfg.num_frontend_tokens if cfg.family == "vlm" else 0
    return -(-(cell.seq_len + extra + 8) // 512) * 512


def cell_arguments(cfg, cell: ShapeCell, mesh, comm: ShapeComm) -> dict:
    """The cell's arguments on ``meta``: the step (a function of ``args``),
    rank ``comm.coord``'s arguments and their bytes (``"arguments"``: as the
    port holds them, by part; ``"rule"``: under JAX's placement)."""
    coord = comm.coord
    gen = MetaGenerator()
    inputs = input_specs(cfg, cell)
    rule_inputs = _input_bytes(inputs, mesh)
    if cell.kind == "train":
        state = init_train_state(cfg, gen)
        par = ParallelContext(cfg, mesh, state.params, comm)
        local = shard_state(state, cfg, mesh, coord)
        step = make_train_step(cfg, cosine_schedule(3e-4, 100, 10000),
                               par=par)
        held = {"state": tree_bytes(local), "inputs": rule_inputs}
        rule = tree_bytes(local) + rule_inputs
        return dict(fn=step, args=(local, inputs), arguments=held, rule=rule)
    params = MD.init_params(cfg, gen, torch.bfloat16, serving=True)
    par = ParallelContext(cfg, mesh, params, comm)
    local = shard_params(params, cfg, mesh, coord)
    if cell.kind == "prefill":
        # the step takes the whole batch and computes its data rank's rows
        step = make_prefill_step(cfg, max_len=_prefill_len(cfg, cell),
                                 par=par)
        held = {"params": tree_bytes(local), "inputs": rule_inputs}
        return dict(fn=step, args=(local, inputs), arguments=held,
                    rule=tree_bytes(local) + rule_inputs)
    kv = (torch.int8 if cfg.amm.enabled and cfg.amm.kv_int8
          else torch.bfloat16)
    cache = MD.init_cache(cfg, cell.global_batch, cell.seq_len, kv,
                          device="meta")
    specs = par.place_cache(cache, cell.global_batch)
    local_cache = unflatten({
        p: take_shard(t, specs[p], mesh, coord, par.parts(p))
        for p, t in flatten(cache).items()})
    rule_cache = _shard_bytes(cache, flatten(cache_shardings(
        cache, cfg, mesh, cell.global_batch)), mesh)
    step = make_decode_step(cfg, par=par)
    held = {"params": tree_bytes(local), "cache": tree_bytes(local_cache),
            "inputs": rule_inputs}
    return dict(fn=step, args=(local, inputs["token"], inputs["pos"],
                               local_cache),
                arguments=held,
                rule=tree_bytes(local) + rule_cache + rule_inputs)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, amm: bool = False,
             force: bool = False, cfg_override=None, mesh_override=None,
             cell_override=None, save: bool = True) -> dict:
    out_path = _cell_path(arch, shape_name, multi_pod, amm)
    if save and out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cell = cell_override or SHAPES[shape_name]
    mesh = mesh_override or make_production_mesh(multi_pod=multi_pod)
    ok, reason = cell_is_applicable(arch, shape_name)
    record = {"arch": arch, "shape": shape_name, "mesh": _mesh_tag(mesh),
              "amm": amm, "kind": cell.kind}
    if not ok:
        record.update(status="skipped", reason=reason)
        if save:
            RESULTS_DIR.mkdir(exist_ok=True)
            out_path.write_text(json.dumps(record, indent=2))
        return record

    cfg = cfg_override or get_config(arch)
    if amm and cfg.family not in ("ssm",):
        cfg = _with_amm(cfg)
    comm = ShapeComm(mesh)
    t0 = time.time()
    c = cell_arguments(cfg, cell, mesh, comm)
    out, cost = run_counted(c["fn"], *c["args"])
    if cell.kind == "decode":  # the cache, updated in place, is returned too
        out = (out, c["args"][3])
    held = c["arguments"]
    record.update(
        status="ok",
        run_s=round(time.time() - t0, 1),
        num_devices=int(math.prod(mesh.shape_tuple)),
        flops_per_device=cost["flops"],
        bytes_per_device=cost["bytes"],
        lut_ops_per_device=cost["lut_ops"],
        memory_analysis={
            "argument_size_bytes": int(sum(held.values())),
            "output_size_bytes": int(tree_bytes(out)),
            "temp_size_bytes": cost["temp_peak_bytes"],
            "generated_code_size_bytes": 0,
            "arguments": held,
            "rule_argument_size_bytes": int(c["rule"]),
        },
        collectives=comm.collectives(),
        tokens=cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                    else 1),
        seq_len=cell.seq_len,
        global_batch=cell.global_batch,
        param_count=cfg.param_count(),
        active_param_count=cfg.active_param_count(),
        corrected=None,
    )
    if save:
        RESULTS_DIR.mkdir(exist_ok=True)
        out_path.write_text(json.dumps(record, indent=2))
    print(f"[dryrun] {arch} × {shape_name} × {record['mesh']}"
          f"{' (amm)' if amm else ''}: OK — "
          f"{record['flops_per_device']:.3e} flops/rank, args "
          f"{record['memory_analysis']['argument_size_bytes'] / 2**30:.2f} "
          f"GiB, temp {record['memory_analysis']['temp_size_bytes'] / 2**30:.2f}"
          f" GiB, {record['run_s']:.1f}s", flush=True)
    return record


def smoke() -> int:
    """The reduced configs × (train_4k, decode_32k) at 64 tokens × batch 4
    on an abstract 2×4 mesh; returns the failures."""
    mesh = AbstractMesh((2, 4), ("data", "model"))
    failures = 0
    for arch in ARCH_IDS:
        cfg = get_config(arch, reduced=True)
        for shape_name in ("train_4k", "decode_32k"):
            cell = SHAPES[shape_name]
            small = ShapeCell(cell.name, 64, 4, cell.kind)
            try:
                rec = run_cell(arch, shape_name, multi_pod=False,
                               cfg_override=cfg, mesh_override=mesh,
                               cell_override=small, save=False, force=True)
                if rec["status"] != "ok":
                    raise RuntimeError(rec)
                print(f"[smoke] {arch} × {shape_name}: OK", flush=True)
            except Exception as e:  # noqa: BLE001 — count it, go on
                traceback.print_exc()
                print(f"[smoke] {arch} × {shape_name}: FAIL {e!r}", flush=True)
                failures += 1
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--amm", action="store_true",
                    help="enable the paper's LUT-MU substitution in MLPs")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)

    if args.smoke:
        raise SystemExit(smoke())

    # every cell of the archs and shapes not pinned by --arch / --shape
    # (--all says so; with neither flag nothing is pinned either)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else tuple(SHAPES)
    cells = [(arch, shape, mp) for mp in meshes for arch in archs
             for shape in shapes]
    failed = []
    for arch, shape, mp in cells:
        try:
            run_cell(arch, shape, multi_pod=mp, amm=args.amm, force=args.force)
        except Exception as e:  # noqa: BLE001 — record the cell, go on
            traceback.print_exc()
            failed.append((arch, shape, mp, repr(e)))
    if failed:
        print(f"\n{len(failed)} FAILED cells:")
        for f in failed:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall {len(cells)} cells OK")


if __name__ == "__main__":
    main()

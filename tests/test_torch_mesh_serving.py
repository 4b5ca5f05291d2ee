"""Serving on a ``data × model`` mesh in the port, on the CPU: one process
per rank on gloo (``torch.multiprocessing.spawn``, a file store in the
test's temporary directory, one torch thread per rank), every check of one
mesh shape in one spawn.

* ``lutmu_matmul_sharded`` on 1×2, 2×2 and 1×4, every backend, input kinds
  ``split``, ``full`` and ``package``: int8 LUTs bit-equal to the
  single-device ``lutmu_matmul`` and to JAX's on the same numpy inputs,
  float32 within ``FLOAT_TOL``; C % tp ≠ 0 falls back.
* MoE: expert parallelism (reduced mixtral, E = 4) on 1×2 and 2×2, TP
  inside the expert (``num_experts=3``) on 1×2: within ``FLOAT_TOL`` of
  the single-device ``moe_apply``, the routing and the local ``inv`` slots
  bitwise.
* Engines: the paged ``ServeEngine`` on 1×2, 2×1 and 2×2 (the dense tiny
  config of ``tests/sharded_check.py``, the same with int8 LUT-MU MLPs
  whose sharded outputs are bitwise over an int8 KV cache, and reduced
  mixtral), with an eviction swap, a prefix hit and a
  copy-on-write clone (on 2×1 and 2×2 both cross data ranks: the pool is
  cut over ``data``); the ``FixedSlotEngine`` on 1×2 and 2×2 (dense,
  reduced mamba2, reduced jamba with LUT-MU) and on 1×4 (the two Mamba
  configs), their Mamba blocks cut over ``model`` (Mamba TP: each rank
  its heads and channels, the state by JAX's ``cache_shardings``).
  Streams equal the
  single-device port engine's, which ``test_torch_serving.py`` and
  ``test_torch_fixed_engine.py`` hold to JAX's; a float stream may leave
  it only where the single-device top-2 margin is within ``LOGIT_TOL``
  (the rule of ``test_torch_fixed_engine.py``).  Every rank's scheduler
  plans and page tables (fixed: slots and positions) equal the
  single-device engine's, step by step, and its params hold exactly the
  bytes of its shards (``local_shape`` of every leaf).  Each rank's page
  pool has the shape of its shard of the pool padded to the data degree
  by JAX's ``paged_cache_shardings`` (plus its write-sink page when the
  pool is cut).
* The placed fixed-slot cache (JAX's ``cache_shardings``): the dense
  tiny config's one kv head does not divide tp, so on 1×2 and 2×2 the
  cache sequence is cut over ``model``; with one slot on 2×1 and 2×2 the
  batch is below the data degree and the sequence is cut over ``data``
  (2×2: ``data``·``model``).  Teacher-forced on the single-device
  stream, every logit the sharded engine samples from is within
  ``LOGIT_TOL`` of the single-device engine's, and each rank's cache
  holds its shard's shape.
* A multi-row ``make_prefill_step`` on 2×1: each rank computes half the
  rows, and the logits equal the single-device step's within
  ``FLOAT_TOL``.  Reduced whisper with one row on 2×1: its self- and
  cross-attention caches' sequences cut over ``data``; prefill and 3
  decode steps within ``LOGIT_TOL`` of one device's.
* ``make_host_mesh`` on worlds of 2 and 4 against JAX's fallback rule;
  ``launch.serve --mesh 2x2``: every rank draws its shards leaf by leaf
  (the params' peak host bytes at most its shards plus one whole layer
  and its shard, below the whole tree) and serves the streams served
  without a mesh.
* Refusals and launchers: ``SpeculativeEngine(mesh=…)`` and ``launch.serve
  --speculative --mesh`` with JAX's messages; ``make_serve_mesh`` on junk
  and on a world of the wrong size; ``launch.serve --mesh 1x1`` serves the
  streams it serves without ``--mesh``; ``compiler lm --mesh 2x2`` records
  the mesh where both packages read it.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

LOGIT_TOL = 1e-4
FLOAT_TOL = 1e-5        # float32 sums of ≤ 8 codebook or k expert terms,
                        # reassociated across ranks
LUT_SHAPE = dict(b=16, c=8, n=32, depth=3, d_sub=4)
# the second prompt shares two pages and part of a third with the first: a
# prefix hit and a copy-on-write clone
PROMPTS = [list(range(1, 13)), list(range(1, 11)) + [30, 31],
           [20, 21, 22, 23, 24, 25, 26, 27, 28, 29], [5, 6], [9, 9, 9, 2]]
MAX_NEW = 8


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _spawn(tmp_path, spec: str, checks):
    d, m = (int(v) for v in spec.split("x"))
    mp.spawn(_rank, args=(d * m, spec, f"file://{tmp_path}/store",
                          str(tmp_path), tuple(checks)),
             nprocs=d * m, join=True)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(d * m)]


def _rank(rank, world, spec, init, out, checks):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_serve_mesh
    mesh = make_serve_mesh(spec, "cpu", init_method=init, rank=rank,
                           world_size=world)
    # the launcher's check runs last: it leaves the process group
    res = {name: _CHECKS[name](mesh) for name in checks}
    torch.save(res, f"{out}/rank{rank}.pt")
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _lut_inputs(int8: bool, c: int, seed: int = 0):
    """Numpy split values, activations, a package and a tree + LUT."""
    s = LUT_SHAPE
    g = 2 ** s["depth"]
    rng = np.random.default_rng(seed)
    arrays = {
        "split_dims": rng.integers(0, s["d_sub"], (c, s["depth"])).astype(
            np.int32),
        "thresholds": rng.normal(size=(c, g - 1)).astype(np.float32),
        "lut": (rng.integers(-128, 128, (c, g, s["n"])).astype(np.int8)
                if int8 else rng.normal(size=(c, g, s["n"])).astype(
                    np.float32)),
        "scale": (np.full((s["n"],), 0.01, np.float32) if int8
                  else np.ones((), np.float32)),
        "offset": rng.normal(size=(s["n"],)).astype(np.float32),
        "split": rng.normal(size=(s["b"], c, s["depth"])).astype(np.float32),
        "full": rng.normal(size=(s["b"], c * s["d_sub"])).astype(np.float32),
        "package": rng.normal(size=(s["b"], s["depth"] * c)).astype(
            np.float32),
    }
    return arrays


def _torch_params(a, lo=0, hi=None):
    from repro_torch.kernels import dispatch as D
    t = {k: torch.from_numpy(a[k]) for k in ("split_dims", "thresholds",
                                              "lut")}
    return D.params_from_arrays(t["split_dims"][lo:hi], t["thresholds"][lo:hi],
                                t["lut"][lo:hi], torch.from_numpy(a["scale"]),
                                torch.from_numpy(a["offset"]))


def _check_lutmu(mesh):
    """Every backend × int8/float32 × input kind, rows split over data as
    the model splits them; outputs gathered whole."""
    from repro_torch.distributed.sharding import ParallelContext
    from repro_torch.kernels import dispatch as D
    par = ParallelContext(_tiny_cfg(False), mesh, {})
    tp, r = par.tp, par.tp_rank
    out = {"hook": set()}
    D.set_profile_hook(lambda **kw: out["hook"].add(
        (kw["input_kind"], kw["b"], kw["c"])))
    for c in (LUT_SHAPE["c"], 7):  # 7: no tp here divides it
        for int8 in (True, False):
            a = _lut_inputs(int8, c)
            cl = c // tp if c % tp == 0 else c
            lo = r * cl if c % tp == 0 else 0
            p = _torch_params(a, lo, lo + cl)
            for be in D.BACKENDS:
                for kind in ("split", "full", "package"):
                    x = par.local_rows(torch.from_numpy(a[kind]))
                    y = D.lutmu_matmul_sharded(x, p, mesh=mesh, backend=be,
                                               input_kind=kind, codebooks=c)
                    out[(c, int8, be, kind)] = par.gather_rows(
                        y, LUT_SHAPE["b"])
    D.set_profile_hook(None)
    return out


def _moe_cfg(num_experts=None):
    from repro_torch.configs import get_config
    cfg = get_config("mixtral-8x7b", reduced=True)
    if num_experts is not None:
        cfg = dataclasses.replace(cfg, num_experts=num_experts)
    return cfg


def _moe_inputs(cfg):
    from repro_torch.models import moe as MOE
    p = MOE.init_moe_params(cfg, torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(4, 5, cfg.d_model)).astype(np.float32))
    return p, x


def _check_moe(mesh):
    """Reduced mixtral with its 4 experts, and with 3 (1×2 only: TP inside
    the expert): the output gathered whole, this rank's routing and local
    ``inv`` slots."""
    from repro_torch.distributed.sharding import (ParallelContext,
                                                  shard_params)
    from repro_torch.models import moe as MOE
    out = {}
    for e in (None, 3):
        cfg = _moe_cfg(e)
        p, x = _moe_inputs(cfg)
        # a one-layer stack, read as the model reads it (FSDP dims
        # gathered at use)
        tree = {"layers": {"moe": {k: v[None] for k, v in p.items()}}}
        par = ParallelContext(cfg, mesh, tree)
        local = par.layer(shard_params(tree, cfg, mesh)["layers"], 0,
                          "layers")["moe"]
        xl = par.local_rows(x)
        y = MOE.moe_apply(local, xl, cfg, par=par)
        _, topi = MOE.route(torch.softmax(
            (xl @ p["router"]).to(torch.float32), dim=-1),
            cfg.num_experts_per_tok)
        e_local = cfg.num_experts // par.tp if par.ep else cfg.num_experts
        e0 = par.tp_rank * e_local if par.ep else 0
        r = MOE.dispatch(topi, cfg.num_experts, MOE.capacity(cfg, 5), e0,
                         e_local)
        out[cfg.num_experts] = dict(
            y=par.gather_rows(y, 4), ep=par.ep, e0=e0, e_local=e_local,
            rows=(par.dp_rank * 4 // par.dp if par.rows_split(4) else 0),
            topi=topi, inv=r["inv"])
    return out


def _tiny_cfg(amm: bool):
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-14b", reduced=True)
    cfg = dataclasses.replace(cfg, num_layers=2, d_model=64, d_ff=128,
                              vocab_size=64, num_heads=2, num_kv_heads=1,
                              head_dim=32)
    if amm:
        cfg = dataclasses.replace(cfg, amm=dataclasses.replace(cfg.amm,
                                                               enabled=True))
    return cfg


def _family_cfg(name: str):
    from repro_torch.configs import get_config
    if name == "dense":
        return _tiny_cfg(False)
    if name == "int8kv":  # int8 LUT-MU MLPs over an int8 KV cache
        cfg = _tiny_cfg(True)
        return dataclasses.replace(cfg, amm=dataclasses.replace(
            cfg.amm, kv_int8=True))
    if name == "moe":
        return _moe_cfg()
    cfg = get_config(name, reduced=True)
    if cfg.is_hybrid:  # one period, LUT-MU MLPs in the dense layers
        cfg = dataclasses.replace(cfg, num_layers=cfg.attn_every,
                                  amm=dataclasses.replace(cfg.amm,
                                                          enabled=True))
    return cfg


def _record(engine, paged: bool, force=None):
    """Log each step's decisions: the scheduler's plan and every live
    request's pages (paged), or the slots and positions (fixed); and each
    request's top-2 logit margin and logits at every token it samples.
    ``force`` (uid → stream) teacher-forces the tokens sampled."""
    log, margins, logits_of = [], {}, {}
    sample = engine._sample

    def _sample(logits, rows_reqs, program):
        top = torch.topk(logits.float(), 2, dim=-1).values
        for row, req in rows_reqs:
            margins.setdefault(req.uid, []).append(
                float(top[row, 0] - top[row, 1]))
            logits_of.setdefault(req.uid, []).append(logits[row].clone())
        out = sample(logits, rows_reqs, program)
        if force is not None:
            for row, req in rows_reqs:
                out[row] = force[req.uid][len(req.generated)]
        return out

    engine._sample = _sample
    if paged:
        schedule = engine.sched.schedule

        def _schedule():
            plan = schedule()
            log.append((
                None if plan.prefill is None else (
                    plan.prefill.req.uid, plan.prefill.start,
                    plan.prefill.n_valid),
                [(row, r.uid) for row, r in plan.decode],
                [r.uid for r, _ in plan.swap_out],
                [r.uid for r in plan.swap_in],
                [(c.src, c.dst) for c in plan.cow],
                sorted((r.uid, tuple(r.pages))
                       for r in engine.sched.live())))
            return plan

        engine.sched.schedule = _schedule
    else:
        step = engine.step

        def _step():
            done = step()
            log.append((sorted((s, r.uid) for s, r in engine.active.items()),
                        engine.pos.tolist()))
            return done

        engine.step = _step
    return log, margins, logits_of


def _serve(engine, paged: bool, force=None):
    log, margins, logits_of = _record(engine, paged, force)
    hs = [engine.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
    engine.run_until_drained()
    return dict(streams=[list(h._req.generated) for h in hs], log=log,
                margins=[margins.get(h._req.uid, []) for h in hs],
                logits=[torch.stack(logits_of[h._req.uid]) for h in hs])


def _engine_cases(mesh, cases):
    from repro_torch.distributed.sharding import (flatten, local_shape,
                                                  param_shardings)
    from repro_torch.models import model as MD
    from repro_torch.serving import FixedSlotEngine, ServeEngine
    out = {}
    for kind, name in cases:
        cfg = _family_cfg(name)
        params = MD.init_params(cfg, torch.Generator().manual_seed(0),
                                serving=True)
        paged = kind == "paged"
        if paged:
            # a pool of 6 pages of 4 for 2 rows: evictions; the prompts
            # share pages: a prefix hit and a copy-on-write clone
            kw = dict(max_batch=2, max_len=32, page_size=4, prefill_chunk=8,
                      num_pages=6)
            make = ServeEngine
        else:
            # "fixed1": one slot, a batch below a data degree of 2
            kw = dict(slots=1 if kind == "fixed1" else 2, max_len=32)
            make = FixedSlotEngine
        # the dense fixed cases teacher-force the single-device stream
        forced = not paged and name == "dense"
        got = []
        for m in (None, mesh):
            engine = make(params, cfg, device="cpu", mesh=m, **kw)
            force = ({i: s for i, s in enumerate(got[0]["streams"])}
                     if forced and m is not None else None)
            res = dict(_serve(engine, paged, force), forced=forced,
                       param_bytes=_bytes(engine.params))
            if m is not None:
                res.update(_placement(engine, paged))
            got.append(res)
        # what this rank's shards of the whole tree hold
        specs = flatten(param_shardings(params, cfg, mesh))
        got[1]["shard_bytes"] = sum(
            math.prod(local_shape(t.shape, specs[p], mesh)) * t.element_size()
            for p, t in flatten(params).items())
        out[(kind, name)] = got
    return out


def _placement(engine, paged: bool) -> dict:
    """What a rank holds of the serving state: the pool's shape and its
    trash page, or each fixed cache leaf's shape beside the shard shape
    JAX's ``cache_shardings`` gives it (Mamba leaves where the block is
    computed whole: their slots only)."""
    from repro_torch.distributed.sharding import (cache_shardings, flatten,
                                                  local_shape)
    from repro_torch.models import model as MD
    if paged:
        return dict(pool=tuple(engine.kv.buffers["k"].shape),
                    trash=engine.kv.trash, dp=engine.par.dp,
                    tp=engine.par.tp, kv_heads=engine.cfg.num_kv_heads,
                    attn_tp=engine.par.attn_tp)
    meta = MD.init_cache(engine.cfg, engine.slots, engine.max_len,
                         engine.cd, "meta")
    rule = flatten(cache_shardings(meta, engine.cfg, engine.mesh,
                                   engine.slots))
    held, want = {}, {}
    for p, t in flatten(engine.cache).items():
        held[p] = tuple(t.shape)
        spec = rule[p]
        if "mamba/" in p and not engine.par.mamba_tp:
            spec = tuple(e if e is not None and "model" not in
                         ((e,) if isinstance(e, str) else e) else None
                         for e in spec)
        want[p] = local_shape(flatten(meta)[p].shape, spec, engine.mesh)
    return dict(cache=held, cache_rule=want, mamba_tp=engine.par.mamba_tp,
                seq_cut={p: engine.par.seq_split(p) for p in held
                         if p.endswith("/k") or p == "k"})


def _bytes(tree) -> int:
    from repro_torch.distributed.sharding import flatten
    return sum(t.numel() * t.element_size() for t in flatten(tree).values())


def _check_amm_mlp(mesh):
    """The LUT-MU MLP of the int8 tiny config, sharded and whole, on the
    same rows: bitwise."""
    from repro_torch.distributed.sharding import (ParallelContext,
                                                  shard_params)
    from repro_torch.models import amm_mlp as AMM
    from repro_torch.models import model as MD
    cfg = _tiny_cfg(True)
    params = MD.init_params(cfg, torch.Generator().manual_seed(0),
                            serving=True)
    par = ParallelContext(cfg, mesh, params)
    local = shard_params(params, cfg, mesh)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, 3, cfg.d_model)).astype(np.float32))
    got = AMM.amm_mlp_apply(par.layer(local["layers"], 0, "layers")[
        "amm_mlp"], x, cfg, par=par)
    want = AMM.amm_mlp_apply(MD.layer_params(params["layers"], 0)["amm_mlp"],
                             x, cfg)
    return torch.equal(got, want)


def _check_paged(mesh):
    return _engine_cases(mesh, [("paged", "dense"), ("paged", "int8kv"),
                                ("paged", "moe")])


def _check_fixed(mesh):
    return _engine_cases(mesh, [("fixed", "dense"), ("fixed", "mamba2-370m"),
                                ("fixed", "jamba-1.5-large-398b")])


def _check_fixed_mamba(mesh):
    return _engine_cases(mesh, [("fixed", "mamba2-370m"),
                                ("fixed", "jamba-1.5-large-398b")])


def _check_fixed1(mesh):
    return _engine_cases(mesh, [("fixed1", "dense")])


def _check_prefill(mesh):
    """A 4-row ``make_prefill_step`` on the mesh and on one device."""
    from repro_torch.distributed.sharding import (ParallelContext,
                                                  shard_params)
    from repro_torch.models import model as MD
    from repro_torch.runtime.steps import make_prefill_step
    cfg = _tiny_cfg(False)
    params = MD.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (4, 6)).astype(np.int32))
    par = ParallelContext(cfg, mesh, params)
    logits, cache = make_prefill_step(cfg, 16, torch.float32, par=par)(
        shard_params(params, cfg, mesh), {"tokens": tokens})
    want, _ = make_prefill_step(cfg, 16, torch.float32)(
        params, {"tokens": tokens})
    return dict(logits=logits, want=want, rows=cache["k"].shape[1],
                dp=par.dp)


def _check_encdec(mesh):
    """Reduced whisper, one row (below the data degree: its self- and
    cross-attention caches' sequences cut over ``data``): prefill, the
    one-row cache spliced into the placed cache, then 3 decode steps, on
    the mesh and on one device; the logits of each."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (ParallelContext, flatten,
                                                  local_shape, shard_params,
                                                  unflatten)
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import _splice_slot
    cfg = get_config("whisper-tiny", reduced=True)
    params = MD.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    frames = torch.from_numpy(rng.normal(size=(
        1, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32))
    tokens = torch.tensor([[3, 1, 4, 1]])
    par = ParallelContext(cfg, mesh, params)
    meta = MD.init_cache(cfg, 1, 16, torch.float32, "meta")
    specs = par.place_cache(meta, 1)
    out = {"cut": {p: par.seq_split(p) for p in ("k", "cross_k")}}
    for name, p, pc in (("want", params, None),
                        ("got", shard_params(params, cfg, mesh), par)):
        _, one = MD.prefill(p, tokens, cfg, 16, extra_embeds=frames,
                            compute_dtype=torch.float32, par=pc)
        if pc is None:
            cache = one
        else:
            cache = unflatten({k: torch.zeros(local_shape(t.shape, specs[k],
                                                          mesh))
                               for k, t in flatten(meta).items()})
            _splice_slot(cache, one, 0, 1, pc)
        out[name] = [MD.decode_step(p, torch.tensor([[t]]),
                                    torch.tensor([4 + i]), cache, cfg,
                                    compute_dtype=torch.float32, par=pc)
                     for i, t in enumerate((5, 9, 2))]
    return out


def _check_host_mesh(mesh):
    """``make_host_mesh`` at shapes that fit the world, exceed it, and
    take part of it: (shape, whether this rank has a coordinate)."""
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    for data, model in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (8, 1)):
        m = make_host_mesh(data, model)
        out[(data, model)] = (tuple(m.mesh.shape), m.mesh_dim_names,
                              m.get_coordinate() is not None)
    return out


def _check_serve_cli(mesh):
    """``launch.serve --mesh`` of this spawn's shape: the params' peak
    host bytes while they are drawn (live storages, ``analysis.cost``'s
    ``OpBytes``), the bytes kept, and rank 0's request lines.  The
    launcher leaves the process group at its end."""
    import contextlib
    import io

    from repro_torch.analysis.cost import OpBytes, tree_bytes
    from repro_torch.device import MetaGenerator
    from repro_torch.launch import serve
    from repro_torch.models import model as MD
    draws = []
    orig = MD.init_params

    def spy(cfg, gen, *a, **kw):
        if isinstance(gen, MetaGenerator):
            return orig(cfg, gen, *a, **kw)
        with OpBytes() as ob:
            out = orig(cfg, gen, *a, **kw)
        draws.append(dict(peak=ob.peak, kept=tree_bytes(out),
                          sharded=kw.get("shard") is not None))
        return out

    shape = "x".join(str(n) for n in mesh.mesh.shape)
    buf = io.StringIO()
    MD.init_params = spy
    try:
        with contextlib.redirect_stdout(buf):
            serve.main(["--arch", "qwen3-14b", "--reduced", "--amm",
                        "--device", "cpu", "--requests", "2", "--max-new",
                        "4", "--mesh", shape])
    finally:
        MD.init_params = orig
    return dict(draws=draws, lines=[ln for ln in buf.getvalue().splitlines()
                                    if ln.strip().startswith("req")])


def _check_refusal(mesh):
    from repro_torch.models import model as MD
    from repro_torch.serving import SpeculativeEngine
    cfg = _tiny_cfg(False)
    params = MD.init_params(cfg, torch.Generator().manual_seed(0))
    try:
        SpeculativeEngine(params, cfg, params, device="cpu", mesh=mesh)
    except NotImplementedError as e:
        return str(e)
    return None


_CHECKS = {"lutmu": _check_lutmu, "moe": _check_moe, "paged": _check_paged,
           "fixed": _check_fixed, "fixed1": _check_fixed1,
           "fixed_mamba": _check_fixed_mamba,
           "encdec": _check_encdec,
           "prefill": _check_prefill, "host_mesh": _check_host_mesh,
           "serve_cli": _check_serve_cli, "amm_mlp": _check_amm_mlp,
           "refusal": _check_refusal}


# ---------------------------------------------------------------------------
# the checks, held in the test process
# ---------------------------------------------------------------------------


def _hold_lutmu(ranks, spec: str):
    import jax.numpy as jnp
    from repro.core import maddness as JM
    from repro.kernels import dispatch as JD
    from repro_torch.kernels import dispatch as D
    dp, tp = (int(v) for v in spec.split("x"))
    for res in ranks:
        # the hook sees each backend pick's per-shard problem
        hook = res["lutmu"].pop("hook")
        b = LUT_SHAPE["b"] // dp
        assert ("sharded:split", b, LUT_SHAPE["c"] // tp) in hook
        assert ("split", b, 7) in hook  # the fallback's whole problem
        for (c, int8, be, kind), got in res["lutmu"].items():
            a = _lut_inputs(int8, c)
            want = D.lutmu_matmul(torch.from_numpy(a[kind]), _torch_params(a),
                                  backend=be, input_kind=kind)
            if int8:
                assert torch.equal(got, want), (c, be, kind)
                jp = JM.MaddnessParams(
                    JM.HashTree(jnp.asarray(a["split_dims"]),
                                jnp.asarray(a["thresholds"])),
                    jnp.zeros((c, 2 ** LUT_SHAPE["depth"], 0)),
                    jnp.asarray(a["lut"]), jnp.asarray(a["scale"]),
                    jnp.asarray(a["offset"]))
                jw = JD.lutmu_matmul(jnp.asarray(a[kind]), jp, backend="ref",
                                     input_kind=kind)
                assert np.array_equal(got.numpy(), np.asarray(jw)), (
                    c, be, kind)
            else:
                torch.testing.assert_close(got, want, rtol=FLOAT_TOL,
                                           atol=FLOAT_TOL)


def _hold_moe(ranks, experts):
    from repro_torch.models import moe as MOE
    for res in ranks:
        for e in experts:
            r = res["moe"][e]
            cfg = _moe_cfg(None if e == 4 else e)
            p, x = _moe_inputs(cfg)
            torch.testing.assert_close(r["y"], MOE.moe_apply(p, x, cfg),
                                       rtol=FLOAT_TOL, atol=FLOAT_TOL)
            assert r["ep"] == (e == 4)
            rows = slice(r["rows"], r["rows"] + r["topi"].shape[0])
            _, topi = MOE.route(torch.softmax(
                (x[rows] @ p["router"]).to(torch.float32), dim=-1),
                cfg.num_experts_per_tok)
            assert torch.equal(r["topi"], topi)
            cap = MOE.capacity(cfg, 5)
            whole = MOE.dispatch(topi, e, cap)["inv"].to(torch.int64)
            expert, el = whole // cap, r["e_local"]
            mine = ((whole < e * cap) & (expert >= r["e0"])
                    & (expert < r["e0"] + el))
            want = torch.where(mine, whole - r["e0"] * cap,
                               torch.full_like(whole, el * cap))
            assert torch.equal(r["inv"].to(torch.int64), want)


def _jax_cfg(name: str):
    """The JAX config with the pool geometry of ``_family_cfg(name)``."""
    from repro.configs import get_config
    cfg = _family_cfg(name)
    arch = "mixtral-8x7b" if name == "moe" else "qwen3-14b"
    return dataclasses.replace(
        get_config(arch, reduced=True), num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, d_model=cfg.d_model)


def _jax_pool_shard(name: str, dp: int, tp: int, num_pages=6, ps=4):
    """``(physical pages, a rank's K shard shape)`` of the pool padded to
    the data degree, by JAX's ``PagedKVCache(pad_to=)`` arithmetic and
    ``paged_cache_shardings``."""
    import jax
    from jax.sharding import AbstractMesh as JAbstractMesh

    from repro.distributed import sharding as JSH
    from repro.models import model as JMD
    jcfg = _jax_cfg(name)
    total = -(-(num_pages + 1) // dp) * dp
    pool = jax.eval_shape(lambda: JMD.init_paged_cache(jcfg, total, ps))
    sh = JSH.paged_cache_shardings(pool, jcfg, JAbstractMesh(
        (dp, tp), ("data", "model")))["k"]
    return total, tuple(sh.shard_shape(tuple(pool["k"].shape)))


def _hold_engines(ranks, key):
    for res in ranks:
        for (kind, name), (single, sharded) in res[key].items():
            assert sharded["log"] == single["log"], (kind, name)
            # the engine holds this rank's shards and nothing whole
            assert sharded["param_bytes"] == sharded["shard_bytes"], (
                kind, name)
            assert sharded["param_bytes"] < single["param_bytes"], (kind, name)
            if sharded["forced"]:
                # teacher-forced: every logit sampled from, token by token
                assert sharded["streams"] == single["streams"]
                for want, got in zip(single["logits"], sharded["logits"]):
                    torch.testing.assert_close(got, want, rtol=0,
                                               atol=LOGIT_TOL)
            for want, got, margin in zip(single["streams"],
                                         sharded["streams"],
                                         single["margins"]):
                if got == want:
                    continue
                at = next(i for i, (a, b) in enumerate(zip(got, want))
                          if a != b)
                assert margin[at] <= LOGIT_TOL, (kind, name, at, margin[at])
            if kind == "paged":
                _hold_pool(single["log"], sharded, name)
            else:
                assert sharded["cache"] == sharded["cache_rule"], (kind, name)
                # the Mamba blocks are cut over model at every tp here
                assert sharded["mamba_tp"] == (name != "dense"), (kind, name)


def _hold_pool(log, sharded, name):
    """The schedule swaps, hits a prefix and clones a page (across data
    ranks on a cut pool); each rank holds its shard of the padded pool."""
    dp = sharded["dp"]
    total, shard = _jax_pool_shard(name, dp, sharded["tp"])
    sink = 1 if dp > 1 else 0
    assert sharded["pool"] == (shard[0], shard[1] + sink) + shard[2:], name
    assert sharded["trash"] == total - 1
    assert any(step[2] for step in log), "no eviction"
    assert any(step[3] for step in log), "no swap-in"
    assert any(step[0] is not None and step[0][1] > 0
               and step[0][0] == 1 for step in log[:6]), "no prefix hit"
    clones = [c for step in log for c in step[4]]
    assert clones, "no copy-on-write clone"
    if dp > 1:
        held = total // dp
        assert any(src // held != dst // held for src, dst in clones), (
            "no clone across data ranks")


def _hold_seq_cut(ranks, key, axes):
    """The dense fixed case's K leaf is cut over ``axes``; over the whole
    world each rank's shard is its rank (row-major, as JAX orders it)."""
    for rank, res in enumerate(ranks):
        (_, sharded), = [v for (kind, name), v in res[key].items()
                         if name == "dense"]
        got = sharded["seq_cut"]["k"]
        assert got is not None and got[0] == axes, got
        if axes == ("data", "model"):
            assert got[1] == rank


def _hold_host_mesh(ranks, world):
    """``make_host_mesh`` against JAX's rule on a JAX of ``world`` host
    devices (``jax.devices`` and ``jax.make_mesh`` stubbed in
    ``repro.launch.mesh``)."""
    import repro.launch.mesh as JM
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(JM.jax, "devices", lambda: list(range(world)))
        mp_.setattr(JM.jax, "make_mesh",
                    lambda shape, axes: (tuple(shape), tuple(axes)))
        for (data, model) in ranks[0]["host_mesh"]:
            want = JM.make_host_mesh(data, model)
            for rank, res in enumerate(ranks):
                shape, names, coord = res["host_mesh"][(data, model)]
                assert (shape, names) == want, (data, model)
                assert coord == (rank < math.prod(shape)), (data, model)


def _hold_serve_cli(ranks, plain):
    """Every rank drew its shards, leaf by leaf: the params' peak host
    bytes at most the kept shards plus one whole layer and its shard (the
    layer drawn, then cut), below the whole tree; rank 0 served the
    streams served without a mesh."""
    from repro_torch.analysis.cost import tree_bytes
    from repro_torch.configs import get_config
    from repro_torch.device import MetaGenerator
    from repro_torch.models import model as MD
    cfg = get_config("qwen3-14b", reduced=True)
    cfg = dataclasses.replace(cfg, amm=dataclasses.replace(cfg.amm,
                                                           enabled=True))
    whole = MD.init_params(cfg, MetaGenerator(), serving=True)
    layer = tree_bytes(whole["layers"]) // cfg.num_layers
    for res in ranks:
        (draw,) = res["serve_cli"]["draws"]
        assert draw["sharded"]
        assert draw["kept"] < tree_bytes(whole)
        assert draw["peak"] <= draw["kept"] + 2 * layer, draw
        assert draw["peak"] < tree_bytes(whole), draw
    assert ranks[0]["serve_cli"]["lines"] == plain


def test_mesh_1x2(tmp_path):
    ranks = _spawn(tmp_path, "1x2", ["lutmu", "moe", "paged", "fixed",
                                     "amm_mlp", "host_mesh", "refusal"])
    _hold_lutmu(ranks, "1x2")
    _hold_moe(ranks, (4, 3))
    _hold_engines(ranks, "paged")
    _hold_engines(ranks, "fixed")
    _hold_seq_cut(ranks, "fixed", ("model",))
    assert all(r["amm_mlp"] for r in ranks)
    from repro.serving.speculative import SpeculativeEngine as JSpec
    with pytest.raises(NotImplementedError) as e:
        JSpec(None, None, None, mesh="a mesh")
    assert all(r["refusal"] == str(e.value) for r in ranks)
    _hold_host_mesh(ranks, 2)


def test_mesh_2x2(tmp_path, capsys):
    ranks = _spawn(tmp_path, "2x2", ["lutmu", "moe", "paged", "fixed",
                                     "fixed1", "amm_mlp", "serve_cli"])
    _hold_lutmu(ranks, "2x2")
    _hold_moe(ranks, (4, 3))
    _hold_engines(ranks, "paged")
    _hold_engines(ranks, "fixed")
    _hold_engines(ranks, "fixed1")
    _hold_seq_cut(ranks, "fixed", ("model",))
    _hold_seq_cut(ranks, "fixed1", ("data", "model"))
    assert all(r["amm_mlp"] for r in ranks)
    _hold_serve_cli(ranks, _serve_cli(capsys))


def test_mesh_2x1(tmp_path):
    ranks = _spawn(tmp_path, "2x1", ["paged", "fixed1", "prefill", "encdec"])
    _hold_engines(ranks, "paged")
    _hold_engines(ranks, "fixed1")
    _hold_seq_cut(ranks, "fixed1", ("data",))
    for rank, r in enumerate(ranks):
        # both of whisper's caches cut over data, this rank's half each
        assert r["encdec"]["cut"] == {"k": (("data",), rank),
                                      "cross_k": (("data",), rank)}
        for got, want in zip(r["encdec"]["got"], r["encdec"]["want"]):
            torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_TOL)
    for r in ranks:
        # each rank computed half of the 4 rows; the logits are all 4
        assert r["prefill"]["dp"] == 2 and r["prefill"]["rows"] == 2
        torch.testing.assert_close(r["prefill"]["logits"],
                                   r["prefill"]["want"], rtol=FLOAT_TOL,
                                   atol=FLOAT_TOL)


def test_mesh_1x4(tmp_path):
    ranks = _spawn(tmp_path, "1x4", ["lutmu", "host_mesh", "fixed_mamba"])
    _hold_lutmu(ranks, "1x4")
    _hold_engines(ranks, "fixed_mamba")
    _hold_host_mesh(ranks, 4)


# ---------------------------------------------------------------------------
# in this process: meshes refused, the launchers
# ---------------------------------------------------------------------------


def test_make_serve_mesh_refuses():
    from repro.launch.mesh import parse_mesh_spec as jparse
    from repro_torch.launch.mesh import make_serve_mesh, parse_mesh_spec
    for junk in ("2by2", "x", "0x2", "2x-1", "2x2x2"):
        with pytest.raises(ValueError) as want:
            jparse(junk)
        with pytest.raises(ValueError) as got:
            make_serve_mesh(junk, "cpu")
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError):
            parse_mesh_spec(junk)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        make_serve_mesh("2x2", "cpu")
    assert not dist.is_initialized()


def _serve_cli(capsys, *extra):
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen3-14b", "--reduced", "--amm", "--device",
                "cpu", "--requests", "2", "--max-new", "4", *extra])
    return [ln for ln in capsys.readouterr().out.splitlines()
            if ln.strip().startswith("req")]


def test_launcher_mesh(capsys):
    plain = _serve_cli(capsys)
    assert len(plain) == 2
    assert _serve_cli(capsys, "--mesh", "1x1") == plain
    assert not dist.is_initialized()
    with pytest.raises(SystemExit) as e:
        _serve_cli(capsys, "--speculative", "--mesh", "1x1")
    assert str(e.value) == ("--speculative serving is single-device for now "
                            "(mesh support is a ROADMAP open item)")
    assert not dist.is_initialized()


def test_compiler_records_mesh(tmp_path):
    from repro.compiler.artifact import load_artifact as jload
    from repro_torch.compiler.__main__ import main
    from repro_torch.compiler.artifact import load_artifact
    out = tmp_path / "lm"
    assert main(["lm", "--arch", "qwen3-14b", "--reduced", "--device", "cpu",
                 "--calib-batch", "2", "--calib-seq", "8", "--mesh", "2x2",
                 "--out", str(out)]) == 0
    want = {"data": 2, "model": 2}
    assert json.loads((out / "manifest.json").read_text())["mesh"] == want
    assert jload(str(out)).manifest["mesh"] == want
    assert load_artifact(str(out)).manifest["mesh"] == want
    assert main(["lm", "--arch", "qwen3-14b", "--reduced", "--device", "cpu",
                 "--mesh", "2by2", "--out", str(tmp_path / "x")]) == 2

"""Training on a ``data × model`` mesh in the port, on the CPU: one process
per rank on gloo (``torch.multiprocessing.spawn``, a file store in a
temporary directory, one torch thread per rank), one spawn per world: the
meshes of a world (1×2 and 2×1; 2×2 and 1×4) are built in turn in it.

* The sharded step (``make_grad_fn`` / ``make_train_step`` with a
  ``ParallelContext``) on 1×2, 2×1, 2×2 and 1×4 for four reduced configs,
  2 layers, ``grad_accum`` 2, float32: qwen3-14b (dense, attention TP at
  tp 2, attention whole at tp 4), qwen3-moe-30b-a3b (expert parallelism,
  the router's partial gradients), mamba2-370m (the Mamba block cut over
  ``model``: part-wise shards, its per-head vectors' partial gradients
  summed by ``grad_sum_axes``) and whisper-tiny with a vocabulary of 511
  (no tp divides it: the head and the embedding whole).  Every gradient
  leaf gathered whole (Mamba's packed leaves joined part by part), the
  loss, the
  grad norm, and every param after two steps equal the single-device
  port's within ``GRAD_TOL`` / ``PARAM_TOL`` (all-reduces and row splits
  sum in another order); under Mamba TP, whose bfloat16-rounded SSD moves
  a rounding on a last-bit difference, the state step by step (after
  step 1, and after step 2 from the mesh's step-1 state).
* 1×1: the sharded step is the single-device step bit for bit (qwen3-14b
  and mamba2-370m, two steps); ``launch.train --production-mesh`` on a
  world of one raises with the ``torchrun`` hint.
* 2×2: two steps of the dense config from JAX's initial state against
  JAX's ``make_train_step`` (the tolerances of ``test_torch_train.py``);
  ``Trainer(mesh=…)`` with one injected failure: one recovery, the losses
  those of the single-device ``Trainer`` within ``GRAD_TOL``; the
  checkpoint it wrote (and that of a mamba2 ``Trainer`` on the mesh, its
  packed leaves gathered part by part) holds, leaf for leaf and byte for
  byte, what a single-device manager writes from the gathered state, which
  is the single-device ``Trainer``'s within ``PARAM_TOL``; ``remesh`` onto
  1×4 with ``state_shardings`` then one more step equals the single
  device's; a ``Trainer`` whose rank 0 fails once to write a checkpoint:
  every rank learns it at the next save and recovers with the others.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# float32 gradients of a 2-layer model summed over other row splits and
# all-reduce orders: a few ulps of values of order 1e-2 … 1
GRAD_TOL = dict(rtol=2e-4, atol=2e-6)
LR = 1e-2
# params after AdamW steps (the rule of test_torch_train.py, per leaf):
# Adam's normalised step m/(√v + eps) turns a last-bit difference of a
# small or cancelling gradient entry into a step up to lr apart, so ≥ 99 %
# of each leaf's entries within PARAM_TOL (a 256-entry norm may hold 2
# such entries) and none further than 2·lr
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_SHARE = 0.99
BATCH, SEQ = 4, 16
CONFIGS = {"dense": ("qwen3-14b", {}),
           "moe": ("qwen3-moe-30b-a3b", {}),
           "mamba": ("mamba2-370m", {}),
           "encdec": ("whisper-tiny", {"vocab_size": 511})}
WORLDS = {2: ("1x2", "2x1"), 4: ("2x2", "1x4")}
MESHES = WORLDS[2] + WORLDS[4]
TRAIN_STEPS, FAIL_AT, CKPT_EVERY = 6, 3, 2
# the steps of each config's Trainer whose checkpoint the mesh writes, and
# its directory (the dense one is the failure run's)
CKPT_RUNS = {"dense": (TRAIN_STEPS, "mesh_ckpt"),
             "mamba": (1, "mamba_ckpt")}
FAILED_WRITE = 2 * CKPT_EVERY  # surfaces at the save after it, step 6


def _cfg(name):
    from repro_torch.configs import get_config
    arch, extra = CONFIGS[name]
    return dataclasses.replace(get_config(arch, reduced=True), num_layers=2,
                               grad_accum=2, **extra)


def _batch(cfg, step):
    from repro_torch.data import TokenStream
    b = {k: torch.from_numpy(v) for k, v in TokenStream(
        vocab_size=cfg.vocab_size, batch_size=BATCH,
        seq_len=SEQ).batch(step).items()}
    if cfg.is_encdec:
        rng = np.random.default_rng(100 + step)
        b["frontend"] = torch.from_numpy(rng.normal(
            size=(BATCH, cfg.num_frontend_tokens, cfg.d_model)).astype(
                np.float32))
    return b


def _state(cfg):
    from repro_torch.runtime.steps import init_train_state
    return init_train_state(cfg, torch.Generator().manual_seed(0))


def _schedule():
    from repro_torch.optim import cosine_schedule
    return cosine_schedule(LR, 1, 10)


def _whole(state, par):
    """A copy of the whole train state on the host."""
    from repro_torch import pytree as T
    from repro_torch.distributed.sharding import unshard_state
    if par is not None:
        return unshard_state(state, par)
    return T.map_tree(lambda t: t.detach().to("cpu", copy=True), state)


def _one_step(cfg, state, i):
    """The single-device step ``i`` from (a copy of) ``state``."""
    from repro_torch import pytree as T
    from repro_torch.runtime.steps import make_train_step
    step = make_train_step(cfg, _schedule(), compute_dtype=torch.float32)
    return step(T.map_tree(torch.clone, state), _batch(cfg, i))[0]


def _run_steps(cfg, state, par=None):
    """The gradients of step 0 (whole), and the losses, grad norms and
    params of two steps, and the whole state after each."""
    from repro_torch import pytree as T
    from repro_torch.runtime.steps import make_grad_fn, make_train_step
    f32 = torch.float32
    grad_fn = make_grad_fn(cfg, compute_dtype=f32, par=par)
    _, grads = grad_fn(state.params, _batch(cfg, 0))
    if par is not None:
        paths = [p for p, _ in T.leaves_with_paths(state.params)]
        with torch.no_grad():
            grads = [par.unshard(g, par.specs[p], parts=par.parts(p))
                     for p, g in zip(paths, grads)]
    step = make_train_step(cfg, _schedule(), compute_dtype=f32, par=par)
    losses, norms, states = [], [], []
    for i in range(2):
        state, m = step(state, _batch(cfg, i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        states.append(_whole(state, par))
    return {"grads": grads, "losses": losses, "norms": norms,
            "params": T.leaves(states[-1].params), "states": states}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _check_steps(mesh, out_dir):
    from repro_torch.device import MetaGenerator
    from repro_torch.distributed.sharding import ParallelContext, shard_state
    from repro_torch.models import model as MD
    res = {}
    for name in CONFIGS:
        cfg = _cfg(name)
        par = ParallelContext(cfg, mesh, MD.init_params(cfg, MetaGenerator()))
        res[name] = _run_steps(cfg, shard_state(_state(cfg), cfg, mesh), par)
        res[name]["flags"] = dict(attn_tp=par.attn_tp, ep=par.ep,
                                  vocab_tp=par.vocab_tp,
                                  mamba_tp=par.mamba_tp)
    return res


def _check_bitwise(mesh, out_dir):
    """1×1: for the dense and the Mamba config, whether the sharded step's
    losses, norms and params are bit-equal to the single-device step's;
    the production mesh refused."""
    from repro_torch.distributed.sharding import ParallelContext, shard_state
    from repro_torch.launch import train as LT
    same = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name in ("dense", "mamba"):
            cfg = _cfg(name)
            one = _run_steps(cfg, _state(cfg))
            st = _state(cfg)
            par = ParallelContext(cfg, mesh, st.params)
            sharded = _run_steps(cfg, shard_state(st, cfg, mesh), par)
            same[name] = (
                one["losses"] == sharded["losses"]
                and one["norms"] == sharded["norms"]
                and all(torch.equal(a, b) for a, b in
                        zip(one["params"] + one["grads"],
                            sharded["params"] + sharded["grads"]))
                and par.mamba_tp == (name == "mamba"))
    finally:
        torch.use_deterministic_algorithms(False)
    try:
        LT.main(["--arch", "qwen3-14b", "--reduced", "--device", "cpu",
                 "--production-mesh", "--steps", "1"])
        refusal = None
    except ValueError as e:
        refusal = str(e)
    return {"same": same, "refusal": refusal}


def _check_jax_state(mesh, out_dir):
    """Two sharded steps of the dense config from JAX's initial state (the
    parent wrote it); the losses, norms and whole params."""
    from repro_torch import pytree as T
    from repro_torch.distributed.sharding import (ParallelContext,
                                                  shard_state, unshard_state)
    from repro_torch.runtime.steps import make_train_step
    cfg = _cfg("dense")
    state = torch.load(f"{out_dir}/jax_state.pt", weights_only=False)
    par = ParallelContext(cfg, mesh, state.params)
    state = shard_state(state, cfg, mesh)
    step = make_train_step(cfg, _schedule(), compute_dtype=torch.float32,
                           par=par)
    losses, norms = [], []
    for i in range(2):
        state, m = step(state, _batch(cfg, i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms,
            "params": T.leaves(unshard_state(state, par).params)}


def _trainer(cfg, ckpt_dir, mesh=None, hook=None):
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    return Trainer(cfg, TrainerConfig(
        ckpt_dir, ckpt_every=CKPT_EVERY, lr=3e-3, warmup_steps=2,
        compute_dtype=torch.float32), lambda s: _batch(cfg, s), mesh=mesh,
        failure_hook=hook, device="cpu")


def _losses_by_step(log):
    """The last loss logged for each step (a replayed step logs twice)."""
    by = {m["step"]: m["loss"] for m in log if "loss" in m}
    return [by[s] for s in sorted(by)]


def _check_trainer(mesh, out_dir):
    """``Trainer`` on this mesh with one injected failure, its state
    gathered; then ``remesh`` onto 1×4 and one more step."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import pytree as T
    from repro_torch.device import MetaGenerator
    from repro_torch.distributed.sharding import state_shardings, unshard_state
    from repro_torch.runtime.steps import init_train_state
    cfg = _cfg("dense")
    crashed = {"done": False}

    def hook(step):
        if step == FAIL_AT and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")

    tr = _trainer(cfg, f"{out_dir}/mesh_ckpt", mesh, hook)
    out = tr.run(TRAIN_STEPS)
    res = {"run": out, "losses": _losses_by_step(tr.metrics_log),
           "gathered": T.leaves(unshard_state(tr.state, tr.par))}
    shape = init_train_state(cfg, MetaGenerator())
    wide = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    tr.remesh(wide, lambda m: state_shardings(shape, cfg, m))
    res["remeshed_tp"] = tr.par.tp
    tr.run(TRAIN_STEPS + 1)
    res["more_losses"] = _losses_by_step(tr.metrics_log)[TRAIN_STEPS:]
    res["after"] = T.leaves(unshard_state(tr.state, tr.par))
    return res


def _check_trainer_mamba(mesh, out_dir):
    """The mamba2 ``Trainer`` on this mesh for ``CKPT_RUNS["mamba"]``
    steps (its checkpoint written from the mesh), its state gathered."""
    from repro_torch import pytree as T
    from repro_torch.distributed.sharding import unshard_state
    steps, sub = CKPT_RUNS["mamba"]
    tr = _trainer(_cfg("mamba"), f"{out_dir}/{sub}", mesh)
    tr.run(steps)
    return {"mamba_tp": tr.par.mamba_tp,
            "gathered": T.leaves(unshard_state(tr.state, tr.par))}


def _check_failed_write(mesh, out_dir):
    """``Trainer`` on this mesh whose rank 0 fails once to write the
    checkpoint of step ``FAILED_WRITE`` (on its writer thread): the next
    save raises on every rank, and all restore the one before it."""
    cfg = _cfg("dense")
    tr = _trainer(cfg, f"{out_dir}/failed_write_ckpt", mesh)
    write, failed = tr.ckpt._write, {"done": False}

    def flaky(step, host):
        if step == FAILED_WRITE and not failed["done"]:
            failed["done"] = True
            raise OSError("injected write failure")
        write(step, host)

    tr.ckpt._write = flaky
    out = tr.run(TRAIN_STEPS)
    return {"run": out, "failed": failed["done"],
            "losses": _losses_by_step(tr.metrics_log),
            "errors": [(m["step"], m["error"]) for m in tr.metrics_log
                       if m.get("event") == "failure"]}


_CHECKS = {"steps": _check_steps, "bitwise": _check_bitwise,
           "jax_state": _check_jax_state, "trainer": _check_trainer,
           "trainer_mamba": _check_trainer_mamba,
           "failed_write": _check_failed_write}


def _params_close(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        close = np.isclose(a, b, **PARAM_TOL)
        assert close.mean() >= PARAM_SHARE, close.mean()
        assert np.abs(a - b).max() <= 2 * LR


def _rank(rank, world, plan, init, out):
    """Build each mesh of ``plan`` (spec → checks) in turn in this world
    (the first through the strict launcher path) and run its checks."""
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_serve_mesh, parse_mesh_spec
    res = {}
    for i, (spec, checks) in enumerate(plan):
        mesh = (make_serve_mesh(spec, "cpu", init_method=init, rank=rank,
                                world_size=world) if i == 0 else
                init_device_mesh("cpu", parse_mesh_spec(spec),
                                 mesh_dim_names=("data", "model")))
        res[spec] = {name: _CHECKS[name](mesh, out) for name in checks}
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _spawn(tmp_path, world: int, plan):
    mp.spawn(_rank, args=(world, tuple(plan), f"file://{tmp_path}/store",
                          str(tmp_path)), nprocs=world, join=True)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# the checks, held in the parent
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single():
    """The single-device port's gradients and steps of every config."""
    torch.set_num_threads(1)
    return {name: _run_steps(_cfg(name), _state(_cfg(name)))
            for name in CONFIGS}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's initial state (written for the 2×2 ranks) and two steps of
    JAX's ``make_train_step`` on the dense config."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.optim import adamw as JAW
    from repro.runtime import steps as JST
    from repro_torch.convert import train_state_from_jax
    d = tmp_path_factory.mktemp("mesh_train_2x2")
    jcfg = dataclasses.replace(get_config("qwen3-14b", reduced=True),
                               num_layers=2, grad_accum=2)
    jstate = JST.init_train_state(jcfg, jax.random.PRNGKey(0))
    torch.save(train_state_from_jax(jstate, "cpu"), d / "jax_state.pt")
    jstep = jax.jit(JST.make_train_step(
        jcfg, JAW.cosine_schedule(LR, 1, 10), compute_dtype=jnp.float32))
    losses, norms = [], []
    for i in range(2):
        jstate, m = jstep(jstate, {k: jnp.asarray(v.numpy()) for k, v in
                                   _batch(_cfg("dense"), i).items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return d, {"losses": losses, "norms": norms,
               "params": [np.asarray(a) for a in
                          jax.tree.leaves(jstate.params)]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_run):
    """One spawn per world, every check of its meshes in it: spec →
    (each rank's results, the spawn's directory)."""
    out = {}
    for world, specs in WORLDS.items():
        plan = [(spec, ["steps"] + (["jax_state", "trainer", "trainer_mamba",
                                     "failed_write"]
                                    if spec == "2x2" else []))
                for spec in specs]
        d = jax_run[0] if world == 4 else tmp_path_factory.mktemp(
            "mesh_train_2")
        results = _spawn(d, world, plan)
        for spec in specs:
            out[spec] = ([r[spec] for r in results], d)
    return out


@pytest.mark.parametrize("name", tuple(CONFIGS))
@pytest.mark.parametrize("spec", MESHES)
def test_sharded_step_equals_single_device(ranks, single, spec, name):
    want = single[name]
    results, _ = ranks[spec]
    got = results[0]["steps"][name]
    for r in results[1:]:  # every rank holds the same whole tree
        assert r["steps"][name]["losses"] == got["losses"]
        assert all(torch.equal(a, b) for a, b in
                   zip(r["steps"][name]["params"], got["params"]))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-5)
    assert len(got["grads"]) == len(want["grads"])
    for a, b in zip(got["grads"], want["grads"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)
    flags = got["flags"]
    if flags["mamba_tp"]:
        # The SSD rounds its scores and x·dt (and their gradients) to
        # bfloat16, as the reference does, so a last-bit difference
        # upstream can move one rounding by a bfloat16 step; Mamba TP sums
        # the out projection, the norm's mean of squares and the B/C and
        # input gradients over the ranks in another order, and Adam
        # carries such a step of step 1 into step 2 (one device against
        # itself with one ulp changed in one out_proj can leave this rule
        # after two steps).  So each step is held on its own, within the
        # same PARAM_TOL / PARAM_SHARE: the whole state after step 1
        # against the single device's, and after step 2 against the
        # single-device step 2 from the mesh's step-1 state.
        from repro_torch import pytree as T
        torch.set_num_threads(1)
        first, second = got["states"]
        _params_close(T.leaves(first), T.leaves(want["states"][0]))
        _params_close(T.leaves(second),
                      T.leaves(_one_step(_cfg(name), first, 1)))
    else:
        _params_close(got["params"], want["params"])
    tp = int(spec.split("x")[1])
    if name == "dense":  # 4 heads, 2 kv heads: TP at tp 2, whole at tp 4
        assert flags["attn_tp"] == (tp <= 2)
    if name == "moe":  # 8 experts: expert-parallel at every tp
        assert flags["ep"]
    if name == "encdec":
        assert flags["vocab_tp"] == (tp == 1)
    # reduced mamba2's 8 heads, 256 channels, 16 of B: cut at every tp
    assert flags["mamba_tp"] == (name == "mamba")


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The 1×1 world's checks, one spawn for every config."""
    (res,) = _spawn(tmp_path_factory.mktemp("mesh_train_1"), 1,
                    [("1x1", ["bitwise"])])
    return res["1x1"]["bitwise"]


@pytest.mark.parametrize("name", ("dense", "mamba"))
def test_1x1_is_single_device_bitwise(one_rank, name):
    assert one_rank["same"][name]
    refusal = one_rank["refusal"]
    assert "torchrun --nproc-per-node 256" in refusal and "16x16" in refusal


def test_2x2_dense_matches_jax(ranks, jax_run):
    _, want = jax_run
    got = ranks["2x2"][0][0]["jax_state"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-4)
    _params_close(got["params"], want["params"])


def test_2x2_trainer_recovers_like_one_device(ranks, tmp_path):
    mesh_run = ranks["2x2"][0][0]["trainer"]
    out = mesh_run["run"]
    assert out["recoveries"] == 1 and out["final_step"] == TRAIN_STEPS
    torch.set_num_threads(1)
    one = _trainer(_cfg("dense"), str(tmp_path / "one"))
    want = one.run(TRAIN_STEPS)
    np.testing.assert_allclose(mesh_run["losses"], want["losses"],
                               **GRAD_TOL)
    from repro_torch import pytree as T
    _params_close(mesh_run["gathered"], T.leaves(one.state))


@pytest.mark.parametrize("name", tuple(CKPT_RUNS))
def test_2x2_checkpoint_bytes_equal_one_device_write(ranks, tmp_path, name):
    import json

    from repro_torch import pytree as T
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime.steps import init_train_state
    from repro_torch.device import MetaGenerator
    results, d = ranks["2x2"]
    steps, sub = CKPT_RUNS[name]
    run = results[0]["trainer" if name == "dense" else "trainer_mamba"]
    gathered = run["gathered"]
    cfg = _cfg(name)
    if name == "mamba":  # the gathered state is the one device's
        assert run["mamba_tp"]
        torch.set_num_threads(1)
        one = _trainer(cfg, str(tmp_path / "one"))
        one.run(steps)
        _params_close(gathered, T.leaves(one.state))
    tree = T.unflatten_like(init_train_state(cfg, MetaGenerator()), gathered)
    CheckpointManager(tmp_path).save(steps, tree, blocking=True)
    name = f"step_{steps:08d}"
    mine, theirs = tmp_path / name, d / sub / name
    a, b = np.load(mine / "leaves.npz"), np.load(theirs / "leaves.npz")
    assert sorted(a.files) == sorted(b.files) and len(a.files) == len(gathered)
    for k in a.files:
        assert a[k].tobytes() == b[k].tobytes(), k
    ma, mb = (json.loads((p / "manifest.json").read_text())
              for p in (mine, theirs))
    assert ma["leaves"] == mb["leaves"] and ma["step"] == mb["step"]


def test_2x2_remesh_to_1x4_then_one_more_step(ranks, tmp_path):
    from repro_torch import pytree as T
    res = ranks["2x2"][0][0]["trainer"]
    assert res["remeshed_tp"] == 4
    torch.set_num_threads(1)
    one = _trainer(_cfg("dense"), str(tmp_path / "one"))
    want = one.run(TRAIN_STEPS + 1)
    np.testing.assert_allclose(res["more_losses"], want["losses"][-1:],
                               **GRAD_TOL)
    _params_close(res["after"], T.leaves(one.state))


def test_2x2_failed_write_recovers_on_every_rank(ranks, tmp_path):
    runs = [r["failed_write"] for r in ranks["2x2"][0]]
    assert [r["failed"] for r in runs] == [True, False, False, False]
    for r in runs:
        assert r["run"]["recoveries"] == 1
        assert r["run"]["final_step"] == TRAIN_STEPS
        assert r["losses"] == runs[0]["losses"]
        ((step, error),) = r["errors"]  # one failure, at the next save
        assert step == FAILED_WRITE + CKPT_EVERY - 1
    assert "injected write failure" in runs[0]["errors"][0][1]
    assert all("rank 0 failed to write a checkpoint" in r["errors"][0][1]
               for r in runs[1:])
    torch.set_num_threads(1)
    want = _trainer(_cfg("dense"), str(tmp_path / "one")).run(TRAIN_STEPS)
    np.testing.assert_allclose(runs[0]["losses"], want["losses"], **GRAD_TOL)

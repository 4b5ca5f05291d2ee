"""The port's training runtime against the JAX package, on the CPU.

* AdamW (one and several updates), the cosine schedule, global-norm
  clipping within rtol 1e-6 / atol 1e-7 of JAX's (float32 ``pow`` and
  norm sums may differ in the last bit); int8 gradient compression codes
  bitwise, scales and residuals within 1e-7 relative.
* ``forward`` (a 2-layer dense stack, float32): loss within 1e-5 and
  gradients within 1e-4 of ``jax.value_and_grad``; remat on and off give
  bit-equal gradients.
* ``make_train_step`` with ``grad_accum`` 2: two steps from JAX's state,
  losses within 1e-5; ≥ 99.9 % of the params within rtol 1e-4 / atol
  1e-5 of JAX's and none further than Adam's bound (lr per step).
* The trainer: the loss falls, one injected failure is recovered from the
  last checkpoint (``recoveries == 1``, the replayed steps' losses
  bit-equal to the first pass), and a crashed run ends bit-equal to an
  uninterrupted one; straggler monitor and host re-mesh as in JAX.
* Checkpoints across packages both ways (float32, bfloat16 and int32
  leaves, a ``TrainState``), bit-equal.
* The ``mlp`` compiler CLI (its artifact accepted by ``python -m
  repro.compiler verify``), ``--ckpt`` on ``lm``/``bundle`` and the serve
  launcher, and ``python -m repro_torch.launch.train --reduced --device
  cpu``.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCkpt
from repro.checkpoint import restore_into as jax_restore_into
from repro.configs import get_config
from repro.models import model as JMD
from repro.optim import adamw as JAW
from repro.optim import compression as JCOMP
from repro.runtime import steps as JST
from repro_torch import pytree as T
from repro_torch.checkpoint import CheckpointManager, restore_into
from repro_torch.compiler import __main__ as cli
from repro_torch.convert import (config_from_jax, params_from_jax,
                                 train_state_from_jax)
from repro_torch.data import TokenStream
from repro_torch.launch import serve as port_serve
from repro_torch.models import model as TMD
from repro_torch.optim import adamw as TAW
from repro_torch.optim import compression as TCOMP
from repro_torch.runtime import steps as TST
from repro_torch.runtime.trainer import StragglerMonitor, Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
OPT_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Small tensors: one intra-op thread.  The suite runs in parallel
    worker processes on a few cores, where every process's default thread
    pool would oversubscribe them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _np(t):
    return t.detach().cpu().numpy()


def _tree_close(port_tree, jax_tree, **tol):
    pl, jl = T.leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(_np(a), np.asarray(b), **tol)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("qwen3-14b", reduced=True)
    cfg = dataclasses.replace(cfg, num_layers=2, d_model=64, d_ff=128,
                              vocab_size=128, num_heads=2, num_kv_heads=1,
                              head_dim=32)
    return cfg, config_from_jax(cfg)


def _grads_tree(rng, params):
    return jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
        params)


def test_adamw_schedule_clip_match_jax():
    rng = np.random.default_rng(0)
    jp = {"w": jnp.asarray(rng.normal(size=(8, 6)).astype(np.float32)),
          "b": {"z": jnp.asarray(rng.normal(size=(6,)).astype(np.float32)),
                "a": jnp.asarray(rng.normal(size=(3, 2)).astype(np.float32))}}
    tp = params_from_jax(jp, "cpu")
    js, ts = JAW.adamw_init(jp), TAW.adamw_init(tp)
    jsched = JAW.cosine_schedule(1e-2, 3, 10)
    tsched = TAW.cosine_schedule(1e-2, 3, 10)
    for step in range(6):
        np.testing.assert_allclose(
            _np(tsched(torch.tensor(step, dtype=torch.int32))),
            np.asarray(jsched(jnp.asarray(step, jnp.int32))), **OPT_TOL)
        jg = _grads_tree(rng, jp)
        tg = params_from_jax(jg, "cpu")
        jg, jn = JAW.clip_by_global_norm(jg, 1.5)
        tg, tn = TAW.clip_by_global_norm(tg, 1.5)
        np.testing.assert_allclose(_np(tn), np.asarray(jn), **OPT_TOL)
        _tree_close(tg, jg, **OPT_TOL)
        lr = jsched(js.step)
        jp, js = JAW.adamw_update(jp, jg, js, lr)
        tp, ts = TAW.adamw_update(tp, tg, ts, tsched(ts.step))
        _tree_close(tp, jp, **OPT_TOL)
        _tree_close(ts.mu, js.mu, **OPT_TOL)
        _tree_close(ts.nu, js.nu, **OPT_TOL)
        assert int(ts.step) == int(js.step) and ts.step.dtype == torch.int32


def test_compression_codes_bitwise_jax():
    rng = np.random.default_rng(1)
    jg = {"a": jnp.asarray(rng.normal(size=(5, 7)).astype(np.float32)),
          "b": jnp.asarray(rng.normal(size=(11,)).astype(np.float32) * 1e-3)}
    js = JCOMP.compression_init(jg)
    ts = TCOMP.compression_init(params_from_jax(jg, "cpu"))
    for _ in range(3):
        jq, jsc, js = JCOMP.compress_gradients(jg, js)
        tq, tsc, ts = TCOMP.compress_gradients(params_from_jax(jg, "cpu"), ts)
        for a, b in zip(T.leaves(tq), jax.tree.leaves(jq)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        _tree_close(tsc, jsc, rtol=1e-7, atol=0)
        _tree_close(ts.residual, js.residual, rtol=1e-6, atol=1e-9)
        _tree_close(TCOMP.dequantize(tq, tsc), JCOMP.dequantize(jq, jsc),
                    rtol=1e-7, atol=0)
        jg = jax.tree.map(lambda a: a * 0.5, jg)


def _batch(cfg, b=4, s=16, step=0):
    return TokenStream(vocab_size=cfg.vocab_size, batch_size=b,
                       seq_len=s).batch(step)


def test_forward_loss_grads_match_jax_and_remat(tiny):
    jcfg, tcfg = tiny
    jp = JMD.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg)
    jl, jg = jax.value_and_grad(JST.make_loss_fn(jcfg, remat=True,
                                                 compute_dtype=jnp.float32))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = {}
    for remat in (True, False):
        tp = params_from_jax(jp, "cpu")
        leaves = [p.requires_grad_(True) for p in T.leaves(tp)]
        loss = TST.make_loss_fn(tcfg, remat=remat,
                                compute_dtype=torch.float32)(tp, tb)
        grads[remat] = torch.autograd.grad(loss, leaves)
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   rtol=1e-5)
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)
    for a, b in zip(grads[True], jax.tree.leaves(jg)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    logits = TMD.forward(params_from_jax(jp, "cpu"), tb["tokens"], tcfg,
                         compute_dtype=torch.float32)
    assert logits.shape == (4, 16, jcfg.vocab_size)
    assert logits.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="A10"):
        TMD.forward(params_from_jax(jp, "cpu"), tb["tokens"],
                    dataclasses.replace(tcfg, family="hybrid", attn_every=2))


def test_train_step_grad_accum_matches_jax(tiny):
    jcfg, tcfg = tiny
    jcfg = dataclasses.replace(jcfg, grad_accum=2)
    tcfg = dataclasses.replace(tcfg, grad_accum=2)
    jstate = JST.init_train_state(jcfg, jax.random.PRNGKey(0))
    tstate = train_state_from_jax(jstate, "cpu")
    jstep = jax.jit(JST.make_train_step(
        jcfg, JAW.cosine_schedule(1e-2, 1, 10), compute_dtype=jnp.float32))
    tstep = TST.make_train_step(tcfg, TAW.cosine_schedule(1e-2, 1, 10),
                                compute_dtype=torch.float32)
    for step in range(2):
        batch = _batch(jcfg, step=step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert int(tstate.step) == 2
    # Adam's normalised step m/(√v + eps) of a gradient entry near eps
    # turns a difference in its last bits (float32 sums of a cancelling
    # gradient in another order) into a step up to lr apart; every other
    # entry agrees closely
    for a, b in zip(T.leaves(tstate.params), jax.tree.leaves(jstate.params)):
        a, b = _np(a), np.asarray(b)
        close = np.isclose(a, b, rtol=1e-4, atol=1e-5)
        assert close.mean() >= 0.999, close.mean()
        assert np.abs(a - b).max() <= 2 * 1e-2


def _stream(cfg):
    ts = TokenStream(vocab_size=cfg.vocab_size, batch_size=4, seq_len=32)
    return ts.batch


def test_trainer_loss_decreases(tiny, tmp_path):
    _, tcfg = tiny
    tr = Trainer(tcfg, TrainerConfig(str(tmp_path), ckpt_every=50, lr=3e-3,
                                     warmup_steps=5,
                                     compute_dtype=torch.float32),
                 _stream(tcfg), device="cpu")
    out = tr.run(30)
    losses = out["losses"]
    assert out["final_step"] == 30
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses
    assert CheckpointManager(tmp_path).latest_step() == 30


def test_trainer_recovery_is_bitwise_deterministic(tiny, tmp_path):
    """A failure at step 7 restores step 4's checkpoint: steps 4..6 are
    replayed with the first pass's losses bit for bit, and the run ends on
    an uninterrupted run's state bit for bit."""
    _, tcfg = tiny

    def make(d, hook=None):
        return Trainer(tcfg, TrainerConfig(str(tmp_path / d), ckpt_every=4,
                                           compute_dtype=torch.float32),
                       _stream(tcfg), failure_hook=hook, device="cpu")

    t1 = make("a")
    out1 = t1.run(12)
    crashed = {"done": False}

    def hook(step):
        if step == 7 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")

    t2 = make("b", hook)
    out2 = t2.run(12)
    assert out2["final_step"] == 12 and out2["recoveries"] == 1
    events = [m for m in t2.metrics_log if m.get("event") == "failure"]
    assert len(events) == 1 and events[0]["step"] == 7
    by_step = {}
    for m in t2.metrics_log:
        if "loss" in m:
            by_step.setdefault(m["step"], []).append(m["loss"])
    assert [len(by_step[s]) for s in range(12)] == [1] * 4 + [2] * 3 + [1] * 5
    assert all(v[0] == v[-1] for v in by_step.values())
    assert [v[-1] for _, v in sorted(by_step.items())] == out1["losses"]
    for a, b in zip(T.leaves(t1.state), T.leaves(t2.state)):
        assert torch.equal(a, b)


def test_trainer_raises_after_max_retries(tiny, tmp_path):
    _, tcfg = tiny

    def always(step):
        if step == 1:
            raise RuntimeError("persistent fault")

    tr = Trainer(tcfg, TrainerConfig(str(tmp_path), ckpt_every=1,
                                     max_retries=2,
                                     compute_dtype=torch.float32),
                 _stream(tcfg), failure_hook=always, device="cpu")
    with pytest.raises(RuntimeError, match="persistent fault"):
        tr.run(3)
    assert tr.recoveries == 3


def test_straggler_monitor_and_remesh(tiny, tmp_path):
    mon = StragglerMonitor(threshold=2.0, patience=2)
    assert not mon.observe(0, 1.0)
    for s in range(1, 5):
        assert not mon.observe(s, 1.0)
    assert not mon.observe(5, 5.0)
    assert mon.observe(6, 5.0)
    assert mon.flagged_steps == [5, 6] and mon.ema < 1.5
    _, tcfg = tiny
    tr = Trainer(tcfg, TrainerConfig(str(tmp_path),
                                     compute_dtype=torch.float32),
                 _stream(tcfg), device="cpu")
    tr.run(2)
    before = [t.clone() for t in T.leaves(tr.state)]
    tr.remesh(None)
    assert all(torch.equal(a, b) for a, b in zip(before, T.leaves(tr.state)))
    tr.run(3)
    assert int(tr.state.step) == 3
    with pytest.raises(NotImplementedError, match="A11"):
        tr.remesh(None, shardings_fn=lambda m: None)


def _mixed_tree(rng):
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "h": rng.normal(size=(5,)).astype(ml_dtypes.bfloat16),
            "n": {"i": np.arange(6, dtype=np.int32).reshape(2, 3),
                  "s": np.asarray(7, np.int32)}}


def test_checkpoints_restore_across_packages(tmp_path):
    rng = np.random.default_rng(5)
    tree = _mixed_tree(rng)
    # JAX writes, the port restores
    JCkpt(tmp_path / "jax").save(3, jax.tree.map(jnp.asarray, tree),
                                 blocking=True)
    template = params_from_jax(jax.tree.map(np.zeros_like, tree), "cpu")
    got = restore_into(template, tmp_path / "jax" / "step_00000003")
    assert got["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["h"].view(torch.int16).numpy(), tree["h"].view(np.int16))
    for k in ("w",):
        np.testing.assert_array_equal(_np(got[k]), tree[k])
    np.testing.assert_array_equal(_np(got["n"]["i"]), tree["n"]["i"])
    assert int(got["n"]["s"]) == 7 and got["n"]["s"].shape == ()
    # the port writes (async, then wait), JAX restores
    mgr = CheckpointManager(tmp_path / "port", keep=2)
    live = params_from_jax(tree, "cpu")
    mgr.save(5, live)
    live["w"].add_(1.0)  # the in-place optimizer's next step: no effect
    mgr.wait()
    back = jax_restore_into(jax.tree.map(jnp.asarray, tree),
                            tmp_path / "port" / "step_00000005")
    np.testing.assert_array_equal(np.asarray(back["w"]), tree["w"])
    np.testing.assert_array_equal(np.asarray(back["h"]).view(np.int16),
                                  tree["h"].view(np.int16))
    for s in (6, 7):
        mgr.save(s, live, blocking=True)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "step_00000006", "step_00000007"]


def test_train_state_checkpoint_across_packages(tiny, tmp_path):
    jcfg, tcfg = tiny
    jstate = JST.init_train_state(jcfg, jax.random.PRNGKey(1))
    JCkpt(tmp_path / "j").save(2, jstate, blocking=True)
    tstate = TST.init_train_state(tcfg, torch.Generator().manual_seed(0))
    got = CheckpointManager(tmp_path / "j").restore(tstate)
    for a, b in zip(T.leaves(got), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    CheckpointManager(tmp_path / "t").save(2, got, blocking=True)
    template = jax.eval_shape(
        lambda: JST.init_train_state(jcfg, jax.random.PRNGKey(0)))
    back = JCkpt(tmp_path / "t").restore(template)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert [p for p, _ in T.leaves_with_paths(got)][:2] == ["0/embed",
                                                            "0/final_norm"]
    assert got.step.dtype == got.opt.step.dtype == torch.int32


def test_cli_mlp_artifact_verified_by_jax(tmp_path, capsys):
    out = tmp_path / "mlp"
    assert cli.main(["mlp", "--device", "cpu", "--samples", "512", "--calib",
                     "256", "--train-steps", "30", "--resolution", "int8",
                     "--out", str(out), "--verify"]) == 0
    text = capsys.readouterr().out
    assert "round-trip bit-identical: True" in text
    assert "accuracy: exact=" in text
    proc = subprocess.run(
        [sys.executable, "-m", "repro.compiler", "verify", str(out)],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "kind=amm_chain" in proc.stdout and "finite=True" in proc.stdout


LM_ARGS = ["--arch", "qwen3-14b", "--reduced", "--device", "cpu"]


def test_ckpt_restores_into_compiler_and_launcher(tmp_path, capsys):
    """A params checkpoint (written by the JAX manager) restores into
    ``lm``, ``bundle`` and the serve launcher; a wrong tree raises."""
    pcfg = get_config("qwen3-14b", reduced=True)
    pcfg = dataclasses.replace(pcfg, amm=dataclasses.replace(pcfg.amm,
                                                             enabled=True))
    jp = JMD.init_params(pcfg, jax.random.PRNGKey(3))
    JCkpt(tmp_path / "ck").save(1, jp, blocking=True)
    ck = str(tmp_path / "ck" / "step_00000001")
    for cmd in ("lm", "bundle"):
        assert cli.main([cmd, *LM_ARGS, "--ckpt", ck, "--out",
                         str(tmp_path / cmd)]) == 0
    restored = restore_into(
        TMD.init_params(config_from_jax(pcfg), torch.Generator()), ck)
    for a, b in zip(T.leaves(restored), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    capsys.readouterr()
    port_serve.main(["--arch", "qwen3-14b", "--reduced", "--device", "cpu",
                     "--ckpt", ck, "--requests", "1", "--max-new", "2"])
    assert "tok/s" in capsys.readouterr().out
    with pytest.raises(ValueError, match="leaves"):
        port_serve.main(["--arch", "qwen3-14b", "--reduced", "--device", "cpu",
                         "--amm", "--ckpt", ck, "--requests", "1"])


def test_launch_train_reduced_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-14b", "--reduced", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "finished at step 3" in proc.stdout
    assert (tmp_path / "step_00000003" / "manifest.json").exists()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-14b", "--production-mesh", "--device", "cpu"],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode != 0 and "A11" in proc.stderr

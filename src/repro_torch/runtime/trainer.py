"""Fault-tolerant training runtime, as in ``repro.runtime.trainer``:

  * **checkpoint/restart** — periodic async checkpoints (atomic commit);
    on a step failure the trainer restores the latest checkpoint and
    replays from there (batches are pure functions of the step index, so
    the replay is exact);
  * **failure injection** — ``failure_hook(step)`` lets tests fail any
    step to drive the recovery path;
  * **straggler mitigation** — a per-step wall-time EMA watchdog;
    sustained outliers are logged and counted;
  * **a device mesh** — ``Trainer(..., mesh=…)`` (a ``("data", "model")``
    ``DeviceMesh``, ``launch/mesh.py``) holds this rank's shards of the
    state and runs the sharded step (``runtime/steps.py``); checkpoints
    are written whole by rank 0 and cut again on restore;
  * **re-mesh** — ``remesh(new_mesh, shardings_fn)`` moves the live state
    through the host and places it on the new mesh's ranks as the sharded
    step reads it (or whole on the device without ``shardings_fn``).

A failed step is retried from the last checkpoint at most
``max_retries`` times in a row; past that the error is raised.  A CUDA
fault that leaves the context unusable therefore surfaces: the retries
fail too, and the last one re-raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import pytree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import MetaGenerator, resolve_device
from repro_torch.distributed.sharding import (ParallelContext, flatten,
                                              leaf_cutter, take_shard,
                                              unshard_state)
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.optim import cosine_schedule
from repro_torch.runtime.steps import TrainState, init_train_state, make_train_step


class StragglerMonitor:
    """EMA step-time watchdog (the per-host signal a coordinator would use)."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0,
                 patience: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.ema: Optional[float] = None
        self.consecutive = 0
        self.flagged_steps: list = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True when a sustained straggler is detected."""
        if self.ema is None:
            self.ema = dt
            return False
        is_slow = dt > self.threshold * self.ema
        # slow steps should not poison the baseline
        if not is_slow:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
            self.consecutive = 0
            return False
        self.consecutive += 1
        self.flagged_steps.append(step)
        return self.consecutive >= self.patience


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_retries: int = 3
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    compute_dtype: Any = torch.bfloat16


class Trainer:
    """The training loop.  ``batch_fn(step)`` is the whole global batch of
    a step, a pure function of the step index (so a replay is exact); on a
    mesh (``mesh``) every rank calls it and the step takes the rank's
    rows."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 batch_fn: Callable[[int], dict], mesh=None,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.batch_fn = batch_fn
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self.monitor = StragglerMonitor()
        self.failure_hook = failure_hook
        self.metrics_log: list = []
        self.recoveries = 0
        self._place(mesh, sharded=mesh is not None)
        self.state: Optional[TrainState] = None

    def _place(self, mesh, sharded: bool) -> None:
        """Run on ``mesh``: with ``sharded`` this rank's shards and the
        sharded step under a parallel context, else the whole state and
        the one-device step."""
        self.mesh = mesh
        self.par = (ParallelContext(self.cfg, mesh, MD.init_params(
            self.cfg, MetaGenerator())) if sharded else None)
        self.ckpt.par = self.par
        tcfg = self.tcfg
        self._step = make_train_step(
            self.cfg, cosine_schedule(tcfg.lr, tcfg.warmup_steps,
                                      tcfg.total_steps),
            compute_dtype=tcfg.compute_dtype, par=self.par)

    def _init_state(self, gen: torch.Generator) -> TrainState:
        """``init_train_state`` on ``gen``; on a mesh this rank's shards of
        it, each leaf drawn whole (as one device draws it) and cut before
        the next is drawn."""
        if self.par is None:
            return init_train_state(self.cfg, gen)
        return init_train_state(self.cfg, gen, shard=leaf_cutter(
            self.cfg, self.mesh, self.par.specs))

    # -- lifecycle ------------------------------------------------------------
    def _fresh(self, seed: int = 0) -> TrainState:
        """The seeded initial state (on a mesh this rank's shards of it)."""
        return self._init_state(
            torch.Generator(device=self.device).manual_seed(seed))

    def init(self, seed: int = 0) -> None:
        self.state = self._fresh(seed)

    def _maybe_restore(self) -> bool:
        self.ckpt.wait()  # a checkpoint still being written counts
        if self.ckpt.latest_step() is None:
            return False
        if self.state is not None:
            template = self.state
        elif self.par is not None:  # shapes only: the rank's shards on meta
            template = self._init_state(MetaGenerator())
        else:
            template = self._fresh()
        self.state = None  # the in-place step may have left it half written
        self.state = self.ckpt.restore(template, device=self.device)
        return True

    # -- main loop ------------------------------------------------------------
    def run(self, num_steps: int) -> dict:
        if self.state is None and not self._maybe_restore():
            self.init()
        retries = 0
        while True:
            step = int(self.state.step)
            if step >= num_steps:
                break
            try:
                t0 = time.time()
                if self.failure_hook is not None:
                    self.failure_hook(step)
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in self.batch_fn(step).items()}
                self.state, metrics = self._step(self.state, batch)
                loss = float(metrics["loss"])  # sync point
                dt = time.time() - t0
                if self.monitor.observe(step, dt):
                    self.metrics_log.append(
                        {"step": step, "event": "straggler", "dt": dt})
                self.metrics_log.append({"step": step, "loss": loss, "dt": dt})
                retries = 0
                if (step + 1) % self.tcfg.ckpt_every == 0:
                    self.ckpt.save(step + 1, self.state)
            except Exception as e:  # noqa: BLE001 — node failure / injected fault
                retries += 1
                self.recoveries += 1
                self.metrics_log.append(
                    {"step": step, "event": "failure", "error": repr(e)})
                if retries > self.tcfg.max_retries:
                    raise
                if not self._maybe_restore():
                    self.init()  # no checkpoint yet: restart from scratch
        self.ckpt.save(int(self.state.step), self.state, blocking=True)
        return {
            "final_step": int(self.state.step),
            "losses": [m["loss"] for m in self.metrics_log if "loss" in m],
            "recoveries": self.recoveries,
            "stragglers": self.monitor.flagged_steps,
        }

    # -- elasticity -----------------------------------------------------------
    def remesh(self, new_mesh, shardings_fn=None) -> None:
        """Re-shard the live state onto another mesh (elastic scaling), as
        the JAX trainer does: the state is gathered whole to the host
        (every rank holds all of it there for a moment), then placed on
        the new mesh's ranks, where the sharded step goes on.  The one
        placement that step reads is ``state_shardings`` on the new mesh,
        so ``shardings_fn(new_mesh)`` (a ``TrainState`` of specs, e.g.
        ``lambda m: state_shardings(state, cfg, m)``) must give it, and any
        other raises; without ``shardings_fn`` the state goes back whole to
        the device and the step runs unsharded.  Every rank of the world
        calls it (e.g. 2×2 → 1×4)."""
        self.ckpt.wait()
        if self.par is not None:
            host = unshard_state(self.state, self.par)
        else:
            host = T.map_tree(lambda t: t.detach().to("cpu", copy=True),
                              self.state)
        self.state = None
        if shardings_fn is None:
            self._place(new_mesh, sharded=False)
            self.state = T.map_tree(lambda t: t.to(self.device), host)
            return
        if new_mesh is None:
            raise ValueError("remesh with shardings needs a mesh")
        given = shardings_fn(new_mesh)
        self._place(new_mesh, sharded=True)
        want = self.par.specs
        if any(flatten(tree) != want for tree in
               (given.params, given.opt.mu, given.opt.nu)):
            raise ValueError("the sharded step reads the state as "
                             "state_shardings places it; shardings_fn gave "
                             "another placement")
        par = self.par
        self.state = T.map_with_path(
            lambda p, t, spec: take_shard(t, spec, new_mesh,
                                          parts=par.parts(p)).to(self.device),
            host, par.state_specs(host))

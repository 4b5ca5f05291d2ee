"""Fault-tolerant training runtime, as in ``repro.runtime.trainer``:

  * **checkpoint/restart** — periodic async checkpoints (atomic commit);
    on a step failure the trainer restores the latest checkpoint and
    replays from there (batches are pure functions of the step index, so
    the replay is exact);
  * **failure injection** — ``failure_hook(step)`` lets tests fail any
    step to drive the recovery path;
  * **straggler mitigation** — a per-step wall-time EMA watchdog;
    sustained outliers are logged and counted;
  * **re-mesh** — ``remesh(new_mesh)`` moves the live state through the
    host and back.  Placing it under new shardings (``shardings_fn``) waits
    for multi-device training (ROADMAP A11).

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
from repro_torch.device import resolve_device
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
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 batch_fn: Callable[[int], dict], mesh=None,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.batch_fn = batch_fn
        self.mesh = mesh
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self.monitor = StragglerMonitor()
        self.failure_hook = failure_hook
        self.metrics_log: list = []
        self.recoveries = 0
        self._step = make_train_step(
            cfg, cosine_schedule(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps),
            compute_dtype=tcfg.compute_dtype)
        self.state: Optional[TrainState] = None

    # -- lifecycle ------------------------------------------------------------
    def _fresh(self, seed: int = 0) -> TrainState:
        return init_train_state(
            self.cfg, torch.Generator(device=self.device).manual_seed(seed))

    def init(self, seed: int = 0) -> None:
        self.state = self._fresh(seed)

    def _maybe_restore(self) -> bool:
        self.ckpt.wait()  # a checkpoint still being written counts
        if self.ckpt.latest_step() is None:
            return False
        template = self.state if self.state is not None else self._fresh()
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
        """Move the live state through the host and back (the one-device
        stand-in for re-sharding onto another mesh)."""
        if shardings_fn is not None:
            raise NotImplementedError(
                "remesh with shardings: multi-device training is not ported "
                "yet (ROADMAP A11)")
        host = T.map_tree(lambda t: t.detach().to("cpu", copy=True),
                          self.state)
        self.state = T.map_tree(lambda t: t.to(self.device), host)
        self.mesh = new_mesh

"""Fault-tolerant training runtime (port of ``repro.runtime.ft``).

- ``TrainRunner``: checkpoint every N steps, resume from the latest
  checkpoint after a failure (an exception from the step, an injected one,
  or a non-finite loss), a per-step wall-time EWMA straggler monitor.
- Because the data stream is a pure function of (seed, step) and the train
  step is pure, a restart resumes the exact loss stream.  On a restart with
  no checkpoint yet the run starts again from the state it was given, which
  the pure step never wrote.
- Over a mesh (``TrainRunner(mesh=)``) every rank runs the runner: the
  failure schedule is the same on every rank, so all fail and resume at
  the same step, and the decisions a rank could take differently -- the
  step to resume from and a straggler flag -- are rank 0's, broadcast.
  Every collective of a step is issued by every rank or by none.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.serving.chaos import ChaosInjector


@dataclass
class StragglerMonitor:
    """EWMA step-time monitor: flags steps slower than ``threshold`` x the
    EWMA (after ``warmup`` steps that only seed it)."""
    alpha: float = 0.1
    threshold: float = 3.0
    warmup: int = 3
    ewma: float = 0.0
    count: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.count += 1
        if self.count <= self.warmup:
            self.ewma = dt if self.ewma == 0 else 0.5 * (self.ewma + dt)
            return False
        slow = dt > self.threshold * self.ewma
        if slow:
            self.flagged.append((step, dt, self.ewma))
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


class FailureInjector(ChaosInjector):
    """Deterministic failure injection: raises at the given steps, each at
    most once (a restarted run that steps through them again does not fail
    again).  The serving chaos harness over one ``train.step`` fault point
    keyed by the step number."""

    def __init__(self, fail_at: set[int] | None = None):
        super().__init__(schedule={"train.step": set(fail_at or ())},
                         points=("train.step",))
        self.fail_at = set(fail_at or ())
        self.fired: set[int] = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            self.events.append(("train.step", step))
            raise RuntimeError(f"injected node failure at step {step}")


@dataclass
class RunReport:
    steps_run: int = 0
    restarts: int = 0
    final_step: int = 0
    losses: list = field(default_factory=list)
    straggler_flags: int = 0


class TrainRunner:
    """Checkpointed training loop with automatic restart from the latest
    checkpoint.  ``train_step(state, batch) -> (state, metrics)`` and
    ``batch_fn(step)`` are pure; all restart state lives in the checkpoint
    and the step index."""

    def __init__(self, train_step: Callable, batch_fn: Callable,
                 ckpt: CheckpointManager, *, ckpt_every: int = 10,
                 monitor: StragglerMonitor | None = None,
                 injector: FailureInjector | None = None,
                 max_restarts: int = 3, mesh=None):
        self.train_step = train_step
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.monitor = monitor or StragglerMonitor()
        self.injector = injector
        self.max_restarts = max_restarts
        self.mesh = mesh if mesh is not None and mesh.size_total > 1 else None

    def _rank0(self, value: float) -> float:
        """``value`` as rank 0 of the mesh has it (``value`` off a mesh)."""
        if self.mesh is None:
            return value
        dev = "cpu" if self.mesh.backend == "gloo" else torch.cuda.current_device()
        t = torch.tensor([value], dtype=torch.float64, device=dev)
        return float(self.mesh.broadcast(t, None)[0])

    def _resume(self, init_state):
        latest = self.ckpt.latest_step()
        latest = int(self._rank0(-1 if latest is None else latest))
        if latest < 0:
            return init_state, 0
        return self.ckpt.restore(latest, init_state), latest

    def run(self, init_state, total_steps: int) -> tuple[Any, RunReport]:
        report = RunReport()
        restarts = 0
        while True:
            state, start = self._resume(init_state)
            try:
                for step in range(start, total_steps):
                    if self.injector is not None:
                        self.injector.maybe_fail(step)
                    t0 = time.time()
                    state, metrics = self.train_step(state, self.batch_fn(step))
                    loss = metrics.get("loss")
                    if loss is not None:
                        loss = float(loss)  # waits for the step on the card
                        if not np.isfinite(loss):
                            raise FloatingPointError(f"non-finite loss at {step}")
                        report.losses.append(loss)
                    if self._rank0(self.monitor.observe(step, time.time() - t0)):
                        report.straggler_flags += 1
                    report.steps_run += 1
                    if (step + 1) % self.ckpt_every == 0 or step + 1 == total_steps:
                        self.ckpt.save(step + 1, state)
                self.ckpt.wait()
                report.restarts = restarts
                report.final_step = total_steps
                return state, report
            except (RuntimeError, FloatingPointError):
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()  # the last save has committed

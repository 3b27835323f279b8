"""Fault tolerance for the training loop: checkpoint/restart, simulated
node failure, straggler mitigation (port of ``repro.train.fault_tolerance``;
the loop, the injector and the monitor are the reference's, over the
port's train step and checkpoints).

On a real 1000+ node deployment the failure signal comes from the
coordinator (missed heartbeat / ICI timeout); here `FaultInjector`
produces the same signal deterministically so the recovery path is
exercised by tests and examples:

  failure -> drop in-flight step -> restore the latest checkpoint into
  the state (in place, on its device) -> replay from the checkpointed
  step with the deterministic data pipeline.

Straggler mitigation: per-step wall times feed an EWMA; steps slower than
``straggler_factor`` x median trigger the mitigation callback (on real
hardware: re-shard away from the slow host / enable backup execution;
here: recorded + surfaced in metrics so the policy is testable).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from repro_torch.train.checkpoint import latest_steps, restore_checkpoint, save_checkpoint


class SimulatedFault(RuntimeError):
    pass


@dataclass
class FaultInjector:
    """Deterministically raise SimulatedFault at the given steps."""

    fail_at_steps: tuple = ()
    fired: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFault(f"injected node failure at step {step}")


@dataclass
class StragglerMonitor:
    factor: float = 3.0
    window: int = 32
    times: list = field(default_factory=list)
    flagged: list = field(default_factory=list)
    on_straggler: Callable[[int, float], None] | None = None

    def record(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        hist = self.times[-self.window :]
        med = float(np.median(hist))
        is_straggler = len(hist) >= 8 and seconds > self.factor * med
        if is_straggler:
            self.flagged.append(step)
            if self.on_straggler:
                self.on_straggler(step, seconds)
        return is_straggler


@dataclass
class FaultTolerantLoop:
    """Drives (state, batch) -> (state, metrics) with checkpoint/restart."""

    step_fn: Callable
    batch_fn: Callable[[int], Any]       # deterministic: step -> batch
    ckpt_dir: str
    ckpt_every: int = 10
    keep: int = 3
    async_ckpt: bool = True
    injector: FaultInjector | None = None
    monitor: StragglerMonitor | None = None
    max_restarts: int = 8

    def run(self, state, n_steps: int, start_step: int = 0):
        metrics_log: list[dict] = []
        restarts = 0
        step = start_step
        pending = None
        while step < n_steps:
            try:
                if self.injector is not None:
                    self.injector.check(step)
                t0 = time.monotonic()
                state, metrics = self.step_fn(state, self.batch_fn(step))
                dt = time.monotonic() - t0
                if self.monitor is not None:
                    self.monitor.record(step, dt)
                metrics_log.append({"step": step, **{k: float(v) for k, v in metrics.items()}})
                step += 1
                if step % self.ckpt_every == 0:
                    pending = save_checkpoint(
                        self.ckpt_dir, step, state,
                        async_write=self.async_ckpt, keep=self.keep,
                    )
            except SimulatedFault:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                if pending is not None:
                    pending.join()
                steps = latest_steps(self.ckpt_dir)
                if steps:
                    step, state = restore_checkpoint(self.ckpt_dir, state)
                else:
                    step = start_step  # no checkpoint yet: replay from scratch
        if pending is not None:
            pending.join()
        return state, metrics_log, restarts

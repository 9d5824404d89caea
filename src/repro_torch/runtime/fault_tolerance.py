"""Fault-tolerant training runner.

The counterpart of ``repro.runtime.fault_tolerance``:

- checkpoint/restart loop: every step is restartable; on an injected fault
  the runner restores the latest checkpoint and continues (bounded
  retries).
- failure injection: deterministic fault schedule for tests / chaos drills.
- straggler watchdog: per-step wall times tracked; a step slower than
  ``straggler_factor`` x the rolling p50 raises a StragglerAlert record,
  surfaced in the run report.

The port's steps update the state in place, where the reference's return a
new one, so the state given to ``run`` is not kept as it was.  A restart
with no checkpoint to go back to (a cold restart) restores a host snapshot
of the initial state, which ``run`` takes when its fault schedule can call
for one; a fault that the step itself raises after steps have completed,
with neither a checkpoint nor that snapshot, cannot be undone and raises.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Iterable, Iterator

from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import copy_into, snapshot


class InjectedFault(RuntimeError):
    """Raised by the fault schedule (simulates a node loss mid-step)."""


@dataclasses.dataclass
class StragglerAlert:
    step: int
    step_time_s: float
    median_s: float


@dataclasses.dataclass
class RunReport:
    steps_completed: int = 0
    restarts: int = 0
    losses: list = dataclasses.field(default_factory=list)
    straggler_alerts: list = dataclasses.field(default_factory=list)
    step_times: list = dataclasses.field(default_factory=list)


class TrainRunner:
    """Drives (state, batch) -> state steps with checkpoint/restart."""

    def __init__(
        self,
        step_fn: Callable,                  # (state, batch, step) -> (state, metrics)
        checkpointer: Checkpointer,
        *,
        checkpoint_every: int = 50,
        max_restarts: int = 3,
        straggler_factor: float = 3.0,
        fault_schedule: Iterable[int] = (),  # steps at which to inject a fault
    ):
        self.step_fn = step_fn
        self.ckpt = checkpointer
        self.checkpoint_every = checkpoint_every
        self.max_restarts = max_restarts
        self.straggler_factor = straggler_factor
        self.fault_schedule = set(fault_schedule)
        self._already_failed: set[int] = set()

    def run(self, state, batches: Iterator, num_steps: int,
            *, start_step: int = 0) -> tuple[object, RunReport]:
        report = RunReport()
        step = start_step
        restarts = 0
        # cold-restart target when no checkpoint exists
        initial = snapshot(state) if self.fault_schedule else None
        # resume from the latest checkpoint if one exists
        latest = self.ckpt.latest_step()
        if latest is not None and latest > step:
            step, state = latest, self.ckpt.restore(latest, state)
        batch_buf = list(batches) if not isinstance(batches, list) else batches

        while step < num_steps:
            batch = batch_buf[step % len(batch_buf)]
            t0 = time.monotonic()
            try:
                if step in self.fault_schedule and step not in self._already_failed:
                    self._already_failed.add(step)
                    raise InjectedFault(f"injected fault at step {step}")
                state, metrics = self.step_fn(state, batch, step)
            except InjectedFault as fault:
                restarts += 1
                report.restarts = restarts
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()  # an in-flight save must commit (or surface)
                restored = self.ckpt.latest_step()
                if restored is not None:
                    state = self.ckpt.restore(restored, state)
                    step = restored
                    continue
                if initial is not None:
                    copy_into(state, initial)  # cold restart: roll back fully
                elif step != start_step:
                    raise RuntimeError("cold restart after completed steps with no "
                                       "checkpoint and no initial snapshot") from fault
                step = start_step
                continue
            dt = time.monotonic() - t0
            report.step_times.append(dt)
            if len(report.step_times) >= 5:
                med = statistics.median(report.step_times[-20:])
                if dt > self.straggler_factor * med:
                    report.straggler_alerts.append(
                        StragglerAlert(step, dt, med))
            if metrics is not None and "loss" in metrics:
                report.losses.append(float(metrics["loss"]))
            step += 1
            report.steps_completed += 1
            if step % self.checkpoint_every == 0:
                self.ckpt.save(step, state)
        self.ckpt.wait()
        return state, report

"""Supervised training loop, and the retry and straggler policy it shares
with the graph serving engine (counterpart of ``repro.ft.supervisor``).

``Supervisor.run`` wraps a train step with the recovery policy:

* **Checkpoint/restart**: periodic async checkpoints; on a worker death
  the loop restores the latest checkpoint and replays from there (the data
  pipeline is a pure function of the step, so replay is exact).
* **Straggler mitigation**: a per-step wall-clock deadline (EWMA of recent
  step times x ``straggler_factor``); after ``max_straggles`` consecutive
  slow steps the supervisor restarts from the checkpoint.
* **NaN/inf quarantine**: a poisoned loss discards the step's update by
  restoring the last checkpoint instead of training on.
* **Bounded retry**: exponential backoff between restarts
  (``backoff_delay``, also the serving engine's retry spacing); it gives
  up after ``max_restarts``.

It reads the loss on the host once a step (``float(metrics["loss"])``),
and the MoE metrics through ``.cpu()``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

from repro_torch.ckpt.checkpoint import CheckpointManager, latest_step
from repro_torch.ft.failures import FaultInjector, WorkerDied
from repro_torch.models.measure import tree_leaves


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    ckpt_every: int = 50
    straggler_factor: float = 3.0
    max_straggles: int = 3
    max_restarts: int = 5
    backoff_base_s: float = 0.01
    ewma: float = 0.9


def backoff_delay(base_s: float, attempt: int) -> float:
    """Exponential backoff schedule (attempt 1 -> base, 2 -> 2x, ...): the
    supervisor's restart spacing and the delay before a quarantined query's
    retry."""
    return base_s * (2 ** max(attempt - 1, 0))


@dataclasses.dataclass
class StragglerClock:
    """EWMA wall-clock deadline.

    ``observe(dt)`` folds a duration into the EWMA and reports whether it
    was a straggle (``dt > factor * ewma``, with the new observation folded
    in first, so a persistent slowdown is not flagged forever).
    ``deadline(floor)`` is the absolute wall-clock bound from the current
    average: the serving engine cancels queries older than it.
    """

    factor: float = 3.0
    ewma: float = 0.9
    avg: Optional[float] = None

    def observe(self, dt: float) -> bool:
        self.avg = (dt if self.avg is None
                    else self.ewma * self.avg + (1 - self.ewma) * dt)
        return dt > self.factor * max(self.avg, 1e-9)

    def deadline(self, floor: float = 0.0) -> Optional[float]:
        """Wall-clock budget implied by the EWMA (None until first sample)."""
        if self.avg is None:
            return None
        return max(self.factor * self.avg, floor)


@dataclasses.dataclass
class Supervisor:
    manager: CheckpointManager
    config: SupervisorConfig = SupervisorConfig()
    injector: Optional[FaultInjector] = None
    # telemetry
    restarts: int = 0
    straggles: int = 0
    nan_events: int = 0
    history: list = dataclasses.field(default_factory=list)
    _last_nan_step: int = -1

    def run(
        self,
        state,
        step_fn: Callable,          # (state, batch) -> (state, metrics)
        batch_fn: Callable,         # step -> batch (pure; replayable)
        start_step: int,
        num_steps: int,
    ):
        """Run ``num_steps`` with recovery. Returns (state, last_step)."""
        cfg = self.config
        step = start_step
        clock = StragglerClock(cfg.straggler_factor, cfg.ewma)
        consecutive_slow = 0
        while step < start_step + num_steps:
            try:
                if self.injector is not None:
                    self.injector.before_step(step)
                t0 = time.monotonic()
                batch = batch_fn(step)
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                if self.injector is not None:
                    loss = self.injector.poison_loss(step, loss)
                dt = time.monotonic() - t0

                if not math.isfinite(loss):
                    # quarantine: drop this update, restore last good state.
                    # A deterministically-poisoned batch (second NaN at the
                    # same step) is skipped instead of replayed forever.
                    self.nan_events += 1
                    state = self._restore(state)
                    if step == self._last_nan_step:
                        step += 1
                    else:
                        self._last_nan_step = step
                        step = self._restored_step(step)
                    continue

                if clock.observe(dt) and step > start_step:
                    consecutive_slow += 1
                    self.straggles += 1
                    if consecutive_slow >= cfg.max_straggles:
                        consecutive_slow = 0
                        state = self._restore(state)
                        step = self._restored_step(step)
                        continue
                else:
                    consecutive_slow = 0

                rec = {"step": step, "loss": loss, "dt": dt}
                for k in ("moe_drop_rate", "moe_load_imbalance"):
                    if k in metrics:
                        rec[k] = metrics[k].cpu().numpy()
                self.history.append(rec)
                step += 1
                if step % cfg.ckpt_every == 0:
                    self.manager.save(step, state)
            except WorkerDied:
                self.restarts += 1
                if self.restarts > cfg.max_restarts:
                    raise
                time.sleep(backoff_delay(cfg.backoff_base_s, self.restarts))
                state = self._restore(state)
                step = self._restored_step(step)
        self.manager.save(step, state, blocking=True)
        return state, step

    # ------------------------------------------------------------------
    def _restore(self, fallback_state):
        """The latest checkpoint, in the live state's structure, dtypes and
        device; the live state itself when nothing is saved yet."""
        try:
            dev = tree_leaves(fallback_state)[0].device
            return self.manager.restore_latest(fallback_state, device=dev)
        except FileNotFoundError:
            return fallback_state  # nothing saved yet: restart from current

    def _restored_step(self, current_step: int) -> int:
        s = latest_step(self.manager.ckpt_dir)
        return s if s is not None else current_step

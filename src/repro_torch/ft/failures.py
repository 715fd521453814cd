"""Deterministic fault injection for the training supervisor and the graph
serving engine (counterpart of ``repro.ft.failures``).

A training step's failure modes are a worker dying (preemption, hardware),
a step hanging (a straggler) and a numerically poisoned update;
``FaultPlan`` scripts them by step and ``FaultInjector`` raises, sleeps or
poisons the loss at those steps, once each, so tests can assert the
supervisor's recovery without nondeterminism.

The serving engine (``serve.graph_engine``) has its own failure
vocabulary: a step's merged frontier blowing the edge budget, a query
arriving with a poisoned source id, a tenant cancelled mid-flight, a
pathological straggler.  ``QueryFaultPlan`` scripts them and
``QueryFaultInjector`` fires each entry once.  Both plans validate at
construction (negative indices are authoring bugs, not faults), and both
injectors record what fired in ``fired``, so tests can assert that every
scripted fault happened.
"""
from __future__ import annotations

import dataclasses
import time


def _check_steps(name: str, steps: tuple, *, pairs: bool = False) -> None:
    """Reject negative step/tick indices in a fault schedule loudly."""
    for s in steps:
        if pairs:
            qid, tick = s
            if qid < 0 or tick < 0:
                raise ValueError(
                    f"{name} entries must be (id >= 0, step >= 0), got {s}")
        elif s < 0:
            raise ValueError(f"{name} step indices must be >= 0, got {s}")


class WorkerDied(RuntimeError):
    """Simulated node failure (preemption, hardware loss)."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    die_at: tuple[int, ...] = ()        # steps raising WorkerDied
    hang_at: tuple[int, ...] = ()       # steps sleeping past the deadline
    nan_at: tuple[int, ...] = ()        # steps whose loss is poisoned to NaN
    hang_seconds: float = 0.2

    def __post_init__(self):
        _check_steps("die_at", self.die_at)
        _check_steps("hang_at", self.hang_at)
        _check_steps("nan_at", self.nan_at)
        if self.hang_seconds < 0:
            raise ValueError(
                f"hang_seconds must be >= 0, got {self.hang_seconds}")


@dataclasses.dataclass
class FaultInjector:
    plan: FaultPlan = FaultPlan()
    fired: set[tuple[str, int]] = dataclasses.field(default_factory=set)

    def before_step(self, step: int) -> None:
        if step in self.plan.die_at and ("die", step) not in self.fired:
            self.fired.add(("die", step))
            raise WorkerDied(f"injected node failure at step {step}")
        if step in self.plan.hang_at and ("hang", step) not in self.fired:
            self.fired.add(("hang", step))
            time.sleep(self.plan.hang_seconds)

    def poison_loss(self, step: int, loss: float) -> float:
        if step in self.plan.nan_at and ("nan", step) not in self.fired:
            self.fired.add(("nan", step))
            return float("nan")
        return loss


@dataclasses.dataclass(frozen=True)
class QueryFaultPlan:
    """Scripted faults for ``serve.graph_engine.GraphServingEngine``.

    * ``overflow_at``: engine ticks at which the merged step is forced to
      report capacity overflow; the engine must quarantine the largest
      predicted contributor instead of truncating co-tenants.
    * ``poison_source``: query ids whose source id is corrupted to
      ``poison_value`` between submit-time validation and admission; the
      engine must reject that query loudly at admission, never expand it.
    * ``cancel_at``: ``(query id, tick)`` pairs, a user disconnect.
    * ``hang_at``: ``(query id, tick)`` pairs, a stall of ``hang_seconds``
      attributed to that query, for driving the straggler deadline.
    """

    overflow_at: tuple[int, ...] = ()
    poison_source: tuple[int, ...] = ()
    cancel_at: tuple[tuple[int, int], ...] = ()
    hang_at: tuple[tuple[int, int], ...] = ()
    hang_seconds: float = 0.05
    poison_value: int = -1

    def __post_init__(self):
        _check_steps("overflow_at", self.overflow_at)
        _check_steps("poison_source", self.poison_source)
        _check_steps("cancel_at", self.cancel_at, pairs=True)
        _check_steps("hang_at", self.hang_at, pairs=True)
        if self.hang_seconds < 0:
            raise ValueError(
                f"hang_seconds must be >= 0, got {self.hang_seconds}")


@dataclasses.dataclass
class QueryFaultInjector:
    """Fires each scripted query fault exactly once (typed ``fired`` set)."""

    plan: QueryFaultPlan = QueryFaultPlan()
    fired: set[tuple[str, int]] = dataclasses.field(default_factory=set)

    def force_overflow(self, tick: int) -> bool:
        if tick in self.plan.overflow_at and ("overflow", tick) not in self.fired:
            self.fired.add(("overflow", tick))
            return True
        return False

    def admitted_source(self, qid: int, source: int) -> int:
        """The source id the engine actually sees at admission."""
        if qid in self.plan.poison_source and ("poison", qid) not in self.fired:
            self.fired.add(("poison", qid))
            return self.plan.poison_value
        return source

    def should_cancel(self, qid: int, tick: int) -> bool:
        if (qid, tick) in self.plan.cancel_at and ("cancel", qid) not in self.fired:
            self.fired.add(("cancel", qid))
            return True
        return False

    def stall(self, qid: int, tick: int) -> None:
        key = ("qhang", qid * 1_000_003 + tick)
        if (qid, tick) in self.plan.hang_at and key not in self.fired:
            self.fired.add(key)
            time.sleep(self.plan.hang_seconds)

"""Deterministic fault injection for the graph serving engine.

Counterpart of the serving side of ``repro.ft.failures``.  The serving
engine (``serve.graph_engine``) has its own failure vocabulary: a step's
merged frontier blowing the edge budget, a query arriving with a poisoned
source id, a tenant cancelled mid-flight, a pathological straggler.
``QueryFaultPlan`` scripts them; it validates at construction (negative
tick indices are authoring bugs, not faults), and ``QueryFaultInjector``
fires each entry once and records what fired in ``fired``, so tests can
assert that every scripted fault happened.  The trainer's ``FaultPlan`` and
``FaultInjector`` come with the LM substrate.
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

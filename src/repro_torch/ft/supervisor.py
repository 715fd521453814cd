"""Retry and straggler policy of the graph serving engine.

Counterpart of the serving side of ``repro.ft.supervisor``:
``backoff_delay`` (the bounded-retry schedule) and ``StragglerClock`` (the
EWMA wall-clock deadline).  The training ``Supervisor`` comes with the LM
substrate.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def backoff_delay(base_s: float, attempt: int) -> float:
    """Exponential backoff schedule (attempt 1 -> base, 2 -> 2x, ...); the
    delay before a quarantined query's retry."""
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

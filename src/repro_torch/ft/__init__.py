"""Fault injection and retry policy of the serving engine."""
from repro_torch.ft.failures import QueryFaultInjector, QueryFaultPlan
from repro_torch.ft.supervisor import StragglerClock, backoff_delay

__all__ = ["QueryFaultInjector", "QueryFaultPlan", "StragglerClock",
           "backoff_delay"]

"""Fault tolerance (counterpart of ``repro.ft``): the training supervisor
and its fault plans, and the serving engine's fault plans and retry
policy."""
from repro_torch.ft.failures import (FaultInjector, FaultPlan,
                                     QueryFaultInjector, QueryFaultPlan,
                                     WorkerDied)
from repro_torch.ft.supervisor import (StragglerClock, Supervisor,
                                       SupervisorConfig, backoff_delay)

__all__ = ["FaultInjector", "FaultPlan", "QueryFaultInjector",
           "QueryFaultPlan", "StragglerClock", "Supervisor",
           "SupervisorConfig", "WorkerDied", "backoff_delay"]

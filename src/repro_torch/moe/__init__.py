"""Expert-dispatch subsystem: planner/executor MoE routing over the IRU.

Counterpart of ``repro.moe``.  ``moe.dispatch`` plans token-to-expert
routing through the hash engine's occupancy machinery (capacity = set
residency, drops = overflow flushes) and executes the scatter, expert-FFN
and combine datapath; ``moe.ep`` runs the executor's bank rows
expert-parallel over ``n_shards`` shards with an int8-compressed combine;
``moe.stats`` is the observability layer.  ``models/moe.py`` delegates all
three engines (dense, iru_sorted, iru_hash) here.  Everything is plain
torch: the reference computes this path in jnp, outside any Pallas kernel.
"""
from repro_torch.moe.dispatch import (
    DispatchPlan,
    capacity,
    execute_plan,
    moe_dense,
    moe_hash,
    moe_sorted,
    plan_dispatch,
)
from repro_torch.moe.ep import moe_hash_ep
from repro_torch.moe.stats import DispatchStats, dispatch_stats, format_stats

__all__ = [
    "DispatchPlan",
    "DispatchStats",
    "capacity",
    "dispatch_stats",
    "execute_plan",
    "format_stats",
    "moe_dense",
    "moe_hash",
    "moe_hash_ep",
    "moe_sorted",
    "plan_dispatch",
]

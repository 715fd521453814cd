"""Per-layer dispatch observability: what the plan did to the token stream.

Counterpart of ``repro.moe.stats``.  A :class:`DispatchStats` holds tensors
only (it stays on the plan's device): overflow drop accounting, the expert
load histogram, and the load-balance quantities the Switch aux loss reads
(``load_fraction`` = cₑ, ``mean_prob`` = mₑ).  Everything derives from the
:class:`~repro_torch.moe.dispatch.DispatchPlan`; only :func:`format_stats`
reads the device from the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.moe.dispatch import _live_rows


@dataclasses.dataclass
class DispatchStats:
    """Observability for one layer's dispatch. Per-expert tensors length E."""

    n_routed: torch.Tensor       # int32[]  live (token, expert) lanes
    n_dropped: torch.Tensor      # int32[]  lanes lost to capacity overflow
    drop_rate: torch.Tensor      # f32[]    n_dropped / max(n_routed, 1)
    expert_load: torch.Tensor    # int32[E] arrivals per expert (histogram)
    expert_kept: torch.Tensor    # int32[E] arrivals served within capacity
    load_fraction: torch.Tensor  # f32[E]   c_e: fraction of lanes per expert
    mean_prob: torch.Tensor      # f32[E]   m_e: mean router prob (aux-loss input)


def dispatch_stats(plan, probs: Optional[torch.Tensor] = None, *,
                   n_live=None) -> DispatchStats:
    """Fold a plan (and optional router probs (T, E)) into stats tensors."""
    n_routed = plan.counts.sum(dtype=torch.int32)
    n_dropped = plan.dropped.sum(dtype=torch.int32)
    denom = n_routed.clamp(min=1).float()
    if probs is None:
        mean_prob = torch.zeros_like(plan.counts, dtype=torch.float32)
    elif n_live is None:
        mean_prob = probs.float().mean(0)
    else:
        T = probs.shape[0]
        m = _live_rows(n_live, T, probs.device)
        lm = (torch.arange(T, dtype=torch.int32, device=probs.device)
              < m).float()[:, None]
        mean_prob = ((probs.float() * lm).sum(0)
                     / m.float().clamp(min=1.0))
    return DispatchStats(
        n_routed=n_routed,
        n_dropped=n_dropped,
        drop_rate=n_dropped.float() / denom,
        expert_load=plan.counts,
        expert_kept=plan.kept,
        load_fraction=plan.counts.float() / denom,
        mean_prob=mean_prob,
    )


def format_stats(stats: DispatchStats, *, max_experts: int = 16) -> str:
    """Host-side one-liner for logs: drop rate + load histogram sketch."""
    load = stats.expert_load.cpu().numpy()
    kept = stats.expert_kept.cpu().numpy()
    routed = int(stats.n_routed.cpu())
    dropped = int(stats.n_dropped.cpu())
    rate = float(stats.drop_rate.cpu())
    head = ",".join(str(int(v)) for v in load[:max_experts])
    tail = ",..." if load.shape[0] > max_experts else ""
    imbalance = float(load.max()) / max(float(load.mean()), 1e-9)
    return (f"dispatch: routed={routed} dropped={dropped} "
            f"drop_rate={rate:.4f} max/mean_load={imbalance:.2f} "
            f"kept={int(kept.sum())} load=[{head}{tail}]")

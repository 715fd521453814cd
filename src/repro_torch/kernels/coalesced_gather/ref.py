"""Plain PyTorch version of the block-reuse gather, and its window contract."""
from __future__ import annotations

import torch


def coalesced_gather_ref(table: torch.Tensor,
                         indices: torch.Tensor) -> torch.Tensor:
    """``table[indices]`` (rows)."""
    return table[indices.long()]


def window_contract_ok(indices: torch.Tensor, *, group: int = 8,
                       window: int = 128) -> torch.Tensor:
    """True iff every ``group``-lane group spans < 2 aligned windows.

    The kernel decides this per group on the device; this whole-stream form
    is the reference's test (the tail group is padded with ``indices[0]``).
    """
    n = indices.shape[0]
    pad = (-n) % group
    fill = indices[:1] if n else torch.zeros(1, dtype=torch.int32,
                                             device=indices.device)
    idx = torch.cat([indices.to(torch.int32),
                     fill.to(torch.int32).expand(pad)])
    g = idx.reshape(-1, group)
    lo = torch.div(g.min(dim=1).values, window, rounding_mode="floor")
    hi = g.max(dim=1).values
    return (hi < (lo + 2) * window).all()

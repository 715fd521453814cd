"""Plain PyTorch version of the segment merge: ``torch.cumsum`` for segment
ids and a scatter reduction over them."""
from __future__ import annotations

import torch

from repro_torch.core.filter import _lane, _merge_init, run_starts


def segment_reduce(values: torch.Tensor, segs: torch.Tensor,
                   op: str) -> torch.Tensor:
    """Per-segment reduction into ``n = len(values)`` segments.

    Like ``jax.ops.segment_*``: ids outside ``[0, n)`` (the ``-1`` of lanes
    before the first run start) are dropped, and empty segments hold the
    identity.  Slot 0 of an ``n + 1`` buffer is the drop sink.
    """
    n = values.shape[0]
    # float sums accumulate in float64: the plain version is then close to
    # the exact sum whatever order the scatter adds in (CUDA atomics add in
    # no fixed order), so it is a yardstick for the kernel's f32 scans
    acc = (torch.float64 if op == "add" and values.dtype.is_floating_point
           else values.dtype)
    buf = torch.full((n + 1,) + tuple(values.shape[1:]),
                     _merge_init(op, values.dtype), dtype=acc,
                     device=values.device)
    dest = (segs + 1).long()
    if op == "add":
        buf.index_add_(0, dest, values.to(acc))
        return buf[1:].to(values.dtype)
    dest = _lane(dest, values).expand_as(values)
    buf.scatter_reduce_(0, dest, values,
                        reduce="amin" if op == "min" else "amax",
                        include_self=True)
    return buf[1:]


def segment_merge_ref(sorted_indices: torch.Tensor, values: torch.Tensor,
                      op: str = "add", active: torch.Tensor | None = None,
                      tags: torch.Tensor | None = None):
    """``(merged, survivors)`` with the contract of ``core.filter.merge_sorted``.

    ``op="tagged"`` (the fused min+add family merge) reduces every run both
    ways, with the inactive lanes inert under each, and each lane takes the
    reduction of its tag's family (True = add).
    """
    if op == "tagged" and tags is None:
        raise ValueError("op='tagged' requires per-lane tags")
    first = run_starts(sorted_indices, active)
    segs = torch.cumsum(first, 0, dtype=torch.int64) - 1
    lane = None if active is None else _lane(active, values)

    def reduce(op):
        vals = values
        if lane is not None:
            vals = torch.where(lane, values, _merge_init(op, values.dtype))
        return segment_reduce(vals, segs, op)[segs]  # segs == -1 wraps, as in jnp

    if op == "tagged":
        out = torch.where(_lane(tags, values), reduce("add"), reduce("min"))
    else:
        out = reduce(op)
    if lane is not None:
        out = torch.where(lane, out, values)
    return out, first

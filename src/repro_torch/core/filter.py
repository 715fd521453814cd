"""Duplicate filtering / merging: the IRU's comparator+adder datapath.

Counterpart of ``repro.core.filter``.  A sorted stream makes duplicate
indices adjacent, so the merge is a segment reduction: the first lane of
each run survives and carries the run's merged payload, every other lane is
deactivated.

``merge_sorted`` for ``add``/``min``/``max`` goes through
``kernels.segment_merge`` (kernel B2 for CUDA tensors, its plain version for
CPU tensors).  ``op="tagged"`` (the fused min+add family of the serving
stack) is plain PyTorch only in this slice.
"""
from __future__ import annotations

from typing import Literal

import torch

FilterOp = Literal["add", "min", "max", "tagged"]


def _merge_init(op: str, dtype: torch.dtype) -> float | int:
    """Neutral element of a merge op at a payload dtype (inert lanes).

    Integer payloads take the dtype extremum; ``"tagged"`` lanes default to
    the ``min`` identity (padding indices carry the min family's tag).
    """
    if op == "add":
        return 0
    if op not in ("min", "max", "tagged"):
        raise ValueError(f"unknown filter op {op!r}")
    if op == "tagged":
        op = "min"
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def run_starts(sorted_indices: torch.Tensor,
               active: torch.Tensor | None = None) -> torch.Tensor:
    """Boolean mask marking the first occurrence of each run of equal indices."""
    prev = torch.cat([sorted_indices[:1] - 1, sorted_indices[:-1]])
    first = sorted_indices != prev
    if active is not None:
        # inactive lanes never start a run
        first = first & active
    return first


def segment_ids(sorted_indices: torch.Tensor,
                active: torch.Tensor | None = None) -> torch.Tensor:
    return torch.cumsum(run_starts(sorted_indices, active), 0,
                        dtype=torch.int32) - 1


def _lane(mask: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Broadcast a lane mask across trailing payload dims ([n] or [n, k])."""
    return mask.reshape(mask.shape + (1,) * (values.dim() - 1))


def _merge_tagged(sorted_indices, values, active, tags):
    """Fused-family merge: per-lane select of the min and add reductions."""
    from repro_torch.kernels.segment_merge.ref import segment_reduce

    if tags is None:
        raise ValueError("op='tagged' requires per-lane tags")
    if values.is_cuda:
        raise NotImplementedError(
            "op='tagged' has no CUDA kernel yet: it comes with the serving "
            "slice of the port")
    first = run_starts(sorted_indices, active)
    segs = torch.cumsum(first, 0, dtype=torch.int64) - 1
    vmin, vadd = values, values
    if active is not None:
        lane = _lane(active, values)
        vmin = torch.where(lane, values, _merge_init("min", values.dtype))
        vadd = torch.where(lane, values, _merge_init("add", values.dtype))
    minned = segment_reduce(vmin, segs, "min")
    summed = segment_reduce(vadd, segs, "add")
    out = torch.where(_lane(tags, values), summed[segs], minned[segs])
    if active is not None:
        out = torch.where(lane, out, values)
    return out, first


def merge_sorted(
    sorted_indices: torch.Tensor,
    values: torch.Tensor,
    op: FilterOp = "add",
    active: torch.Tensor | None = None,
    tags: torch.Tensor | None = None,
):
    """Merge duplicate adjacent indices -> ``(merged_values, survivor_mask)``.

    ``merged_values[i]`` is the reduction of ``values`` over the run holding
    lane ``i``; ``survivor_mask`` marks the first active lane of each run.
    Inactive lanes never start a run, contribute the identity and keep their
    own value.  Domain: ``active`` is a prefix of the stream (what the sort
    engine passes); off it the reference indexes segment ``-1``.
    """
    if op == "tagged":
        return _merge_tagged(sorted_indices, values, active, tags)
    from repro_torch.kernels.segment_merge.ops import segment_merge

    return segment_merge(sorted_indices, values, op=op, active=active)


def filter_rate(survivor_mask: torch.Tensor,
                active: torch.Tensor | None = None) -> torch.Tensor:
    """Fraction of elements filtered out (paper Figure 15; avg 48.5%)."""
    if active is None:
        return 1.0 - survivor_mask.sum() / survivor_mask.shape[0]
    total = active.sum().clamp(min=1)
    kept = (survivor_mask & active).sum()
    return 1.0 - kept.float() / total.float()


def compact(actives: torch.Tensor, *arrays: torch.Tensor):
    """Stable-compact surviving lanes to the front.

    Returns ``(new_active, *compacted_arrays)``; trailing slots hold the
    inactive lanes in stable order.
    """
    order = torch.sort((~actives).to(torch.int32), stable=True).indices
    return (actives[order],) + tuple(a[order] for a in arrays)

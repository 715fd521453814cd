"""Duplicate filtering / merging: the IRU's comparator+adder datapath.

Counterpart of ``repro.core.filter``.  A sorted stream makes duplicate
indices adjacent, so the merge is a segment reduction: the first lane of
each run survives and carries the run's merged payload, every other lane is
deactivated.

``merge_sorted`` goes through ``kernels.segment_merge`` (kernel B2 for CUDA
tensors, its plain version for CPU tensors), for ``add``/``min``/``max`` and
for ``op="tagged"``, the fused min+add family of the serving stack.
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
    Inactive lanes never start a run, contribute nothing and keep their
    own value.  ``op="tagged"``: ``tags`` marks each lane's family (False =
    min, True = add); equal indices share a tag, so every run is
    uniform-tag.  Domain: ``active`` is a prefix of the stream (what the sort
    engine passes); off it the reference indexes segment ``-1``.
    """
    from repro_torch.kernels.segment_merge.ops import segment_merge

    return segment_merge(sorted_indices, values, op=op, active=active,
                         tags=tags)


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

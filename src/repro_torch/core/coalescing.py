"""Memory-coalescing cost model -- the paper's Figure 14 metric.

Counterpart of ``repro.core.coalescing``.  The GPU coalescer issues one L1
request per distinct 128 B memory block touched by the 32 threads of a
warp: indices are grouped into lane groups of 32, and each group counts the
distinct aligned blocks (``addr // 128``) it touches.  The IRU keys its
reorder on the same block id.

The counting functions are torch on any device (the card counts a
full-size trace where it was taken); they accept tensors or numpy arrays.
"""
from __future__ import annotations

import torch

# Paper constants: 128 B cache lines, warp of 32 threads.
BLOCK_BYTES = 128
GROUP = 32

# Block id of disabled lanes and padding; never a real block, because
# indices are non-negative, and it sorts after every real block.
_SENTINEL = torch.iinfo(torch.int32).max


def elems_per_block(elem_bytes: int, block_bytes: int = BLOCK_BYTES) -> int:
    if elem_bytes <= 0 or block_bytes % elem_bytes:
        raise ValueError(
            f"elem_bytes={elem_bytes} must divide block_bytes={block_bytes}")
    return block_bytes // elem_bytes


def block_ids(indices: torch.Tensor, elem_bytes: int = 4,
              block_bytes: int = BLOCK_BYTES) -> torch.Tensor:
    """Aligned memory-block id touched by each index (int32)."""
    return torch.div(indices.to(torch.int32),
                     elems_per_block(elem_bytes, block_bytes),
                     rounding_mode="floor")


def _pad_to_groups(x: torch.Tensor, fill, group: int = GROUP) -> torch.Tensor:
    pad = (-x.shape[0]) % group
    if pad:
        x = torch.cat([x, x.new_full((pad,), fill)])
    return x.reshape(-1, group)


def accesses_per_group(indices, active=None, *, elem_bytes: int = 4,
                       block_bytes: int = BLOCK_BYTES,
                       group: int = GROUP) -> torch.Tensor:
    """Number of memory-block requests each ``group``-lane group issues.

    Returns int32 ``[ceil(n / group)]`` on the indices' device; a group
    whose lanes are all inactive costs 0.  This is the per-warp-instruction
    request count of the paper's Figure 14.
    """
    blocks = block_ids(torch.as_tensor(indices), elem_bytes, block_bytes)
    if active is not None:
        act = torch.as_tensor(active, device=blocks.device).to(torch.bool)
        blocks = torch.where(act, blocks, _SENTINEL)
    srows = torch.sort(_pad_to_groups(blocks, _SENTINEL, group), dim=1).values
    # distinct = 1 + number of adjacent differences among valid entries
    valid = srows != _SENTINEL
    diff = (srows[:, 1:] != srows[:, :-1]) & valid[:, 1:]
    return valid[:, 0].to(torch.int32) + diff.sum(1, dtype=torch.int32)


def total_accesses(indices, active=None, **kw) -> torch.Tensor:
    return accesses_per_group(indices, active, **kw).sum()


def mean_accesses_per_group(indices, active=None, **kw) -> torch.Tensor:
    """Average requests per group, counting only groups with an active
    lane."""
    per = accesses_per_group(indices, active, **kw)
    return per.sum() / (per > 0).sum().clamp(min=1)


def coalescing_improvement(base_indices, new_indices, new_active=None,
                           **kw) -> torch.Tensor:
    """Paper headline metric: baseline accesses / IRU accesses (1.32x)."""
    base = total_accesses(base_indices, **kw)
    new = total_accesses(new_indices, new_active, **kw)
    return base.to(torch.float32) / new.clamp(min=1).to(torch.float32)

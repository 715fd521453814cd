"""Memory-block geometry of the coalescing model (paper: 128 B lines).

Counterpart of the block-id part of ``repro.core.coalescing``: the IRU keys
its reorder on the aligned memory block an index touches (``addr // 128``).
"""
from __future__ import annotations

import torch

BLOCK_BYTES = 128  # paper: 128 B cache lines


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

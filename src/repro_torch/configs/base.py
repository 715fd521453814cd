"""Config descriptors (counterpart of ``repro.configs.base``): the MoE
layer's, with the reference's fields and defaults."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    n_shared_experts: int = 0
    layer_period: int = 1          # MoE every k-th layer
    layer_offset: int = 0
    first_dense_layers: int = 0    # leading layers keep dense FFN (deepseek)
    capacity_factor: float = 1.25
    dispatch: str = "iru_sorted"   # "iru_sorted" | "iru_hash" | "dense" (baseline)

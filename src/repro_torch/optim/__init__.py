"""Optimizer (counterpart of ``repro.optim``): AdamW with fp32, bf16 or
int8 moments, updated in place, and the LR schedules.  The blockwise int8
quantizer is shared with ``dist.collectives``."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     dequantize_i8, global_norm, quantize_i8)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "dequantize_i8",
    "global_norm",
    "linear_warmup_cosine",
    "quantize_i8",
]

"""Optimizer pieces (counterpart of ``repro.optim``): so far only the
blockwise int8 quantizer that the compressed collectives share."""
from repro_torch.optim.adamw import dequantize_i8, quantize_i8

__all__ = ["dequantize_i8", "quantize_i8"]

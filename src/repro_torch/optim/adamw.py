"""Blockwise int8 quantization (counterpart of ``repro.optim.adamw``'s).

The reference stores AdamW moments as int8 with one f32 scale per block of
128 consecutive elements; ``dist.collectives`` reuses the same quantizer
for its compressed traffic.  Only the quantizer is ported so far; the
optimizer comes with the training slice.  ``torch.round`` rounds half to
even, as ``jnp.round`` does, so the codes equal the reference's bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_BLOCK = 128


def _blocked(x: torch.Tensor):
    """Flatten into (blocks, _BLOCK) rows, zero-padding a ragged tail."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % _BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, _BLOCK), pad


def quantize_i8(x: torch.Tensor) -> dict:
    """Signed linear int8 per 128-block: q = round(x / (blockmax / 127)).

    -> {"q": int8 (blocks, 128), "scale": f32 (blocks, 1)}; the target
    shape is supplied again at dequantize time."""
    b, _ = _blocked(x)
    scale = b.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(b / scale.clamp(min=1e-20)).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def dequantize_i8(s: dict, shape) -> torch.Tensor:
    flat = (s["q"].float() * s["scale"]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)

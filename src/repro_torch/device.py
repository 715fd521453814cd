"""Device resolution for the port's entry points: the card by default.

There is no silent CPU fallback: ``device=None`` means CUDA, and a machine
without a card raises unless the caller asks for the CPU explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)

"""Device resolution for the port's entry points: the card by default.

There is no silent CPU fallback: ``device=None`` means CUDA, and a machine
without a card raises unless the caller asks for the CPU explicitly.
"""
from __future__ import annotations

import os

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


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """A process-group rank's device: ``None`` -> ``cuda:{LOCAL_RANK %
    device_count()}`` (raises without a card, as :func:`resolve_device`
    does); anything else as given."""
    if device is None:
        resolve_device(None)
        local = int(os.environ.get("LOCAL_RANK", "0"))
        return torch.device("cuda", local % torch.cuda.device_count())
    return torch.device(device)

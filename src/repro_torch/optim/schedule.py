"""LR schedules (counterpart of ``repro.optim.schedule``): functions of a
device step tensor, so a train step reads nothing on the host."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step: torch.Tensor, total_steps: int, *,
                    final_frac: float = 0.1) -> torch.Tensor:
    t = torch.clamp(step.float() / max(total_steps, 1), 0.0, 1.0)
    return final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))


def linear_warmup_cosine(step: torch.Tensor, warmup: int, total_steps: int,
                         *, final_frac: float = 0.1) -> torch.Tensor:
    w = torch.clamp(step.float() / max(warmup, 1), 0.0, 1.0)
    return w * cosine_schedule(torch.clamp(step - warmup, min=0),
                               max(total_steps - warmup, 1),
                               final_frac=final_frac)

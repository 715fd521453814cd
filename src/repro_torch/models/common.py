"""Shared model building blocks: the param factory with logical axes, FFN.

Counterpart of ``repro.models.common``.  Every parameter is created through
:class:`Initializer`, which builds two parallel nested dicts -- the tensors
and their *logical axis names* -- so a sharding layer can later derive its
layouts without a second source of truth.  Randomness comes from an
explicit ``torch.Generator``; a child scope shares its parent's generator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

Params = dict
Specs = dict


@dataclasses.dataclass
class Initializer:
    """Scoped factory producing (params, logical_axis_specs) in lockstep.

    ``device=None`` is the card (raises without one); pass ``device="cpu"``
    to build on the CPU.  Random weights are drawn on the generator's
    device, then moved to ``device``.
    """

    generator: torch.Generator
    dtype: torch.dtype = torch.bfloat16
    device: Optional[str | torch.device] = None
    params: Params = dataclasses.field(default_factory=dict)
    specs: Specs = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def sub(self, name: str) -> "Initializer":
        child = Initializer(self.generator, self.dtype, self.device)
        self.params[name] = child.params
        self.specs[name] = child.specs
        return child

    def weight(
        self,
        name: str,
        shape: tuple[int, ...],
        axes: tuple[Optional[str], ...],
        *,
        scale: float | None = None,
        init: str = "normal",
        dtype: Optional[torch.dtype] = None,
    ) -> None:
        assert len(shape) == len(axes), (name, shape, axes)
        dt = dtype or self.dtype
        if init == "zeros":
            arr = torch.zeros(shape, dtype=dt, device=self.device)
        elif init == "ones":
            arr = torch.ones(shape, dtype=dt, device=self.device)
        else:
            fan_in = shape[0]  # the reference's rule, for any rank
            s = scale if scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
            arr = torch.randn(shape, generator=self.generator,
                              dtype=torch.float32,
                              device=self.generator.device) * s
            arr = arr.to(device=self.device, dtype=dt)
        self.params[name] = arr
        self.specs[name] = axes


def init_ffn(it: Initializer, d_model: int, d_ff: int, ffn_type: str) -> None:
    if ffn_type == "swiglu":
        it.weight("wi", (d_model, d_ff), ("embed", "ffn"))
        it.weight("wg", (d_model, d_ff), ("embed", "ffn"))
    else:  # gelu (classic 2-matrix MLP)
        it.weight("wi", (d_model, d_ff), ("embed", "ffn"))
    it.weight("wo", (d_ff, d_model), ("ffn", "embed"))


def ffn(params: Params, x: torch.Tensor, ffn_type: str) -> torch.Tensor:
    if ffn_type == "swiglu":
        h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    else:
        h = F.gelu(x @ params["wi"], approximate="tanh")  # jax.nn.gelu's default
    return h @ params["wo"]

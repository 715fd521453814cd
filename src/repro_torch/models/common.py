"""Shared model building blocks: the param factory with logical axes,
norms, FFN.

Counterpart of ``repro.models.common``.  Every parameter is created through
:class:`Initializer`, which builds two parallel nested dicts -- the tensors
and their *logical axis names* -- so a sharding layer can later derive its
layouts without a second source of truth.  Randomness comes from an
explicit ``torch.Generator``; a child scope shares its parent's generator.

:func:`constrain` is called where the reference pins an activation's
sharding.  Under ``dist.sharding.use_mesh`` it resolves the logical axes
against the mesh (a wrong axes tuple raises, as the reference's assert
does) and returns the tensor itself: one process holds it whole and
redistributes nothing.  Outside a mesh it returns at once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (constraints_enabled, current_mesh,
                                       resolve_spec)
from repro_torch.models.measure import tree_leaves, tree_map

Params = dict
Specs = dict


@dataclasses.dataclass
class Initializer:
    """Scoped factory producing (params, logical_axis_specs) in lockstep.

    ``device=None`` is the card (raises without one); pass ``device="cpu"``
    to build on the CPU.  Random weights are drawn in f32 on the
    generator's device, then cast and moved to ``device``.  On the ``meta``
    device nothing is drawn (``generator`` may be None): the tree holds
    shapes and dtypes only.
    """

    generator: Optional[torch.Generator]
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
        if self.device.type == "meta":
            arr = torch.empty(shape, dtype=dt, device=self.device)
        elif init == "zeros":
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

    def vmap_unit(self, name: str, n: int,
                  build: Callable[["Initializer"], None]) -> None:
        """Create ``n`` stacked copies of a unit (for the loop over layers).

        The build function sees a scoped Initializer; resulting tensors gain
        a leading ``layers`` axis.  Each leaf is one preallocated ``[n, ...]``
        tensor filled one copy at a time, so the peak is the stack plus one
        unit (and one leaf's f32 draw), never two stacks.
        """
        stacked = None
        for i in range(n):
            it = Initializer(self.generator, self.dtype, self.device)
            build(it)
            if stacked is None:
                stacked = tree_map(lambda v: v.new_empty((n,) + v.shape),
                                   it.params)
                self.specs[name] = _prefix_axes(it.specs)
            for dst, src in zip(tree_leaves(stacked), tree_leaves(it.params)):
                dst[i].copy_(src)
            if self.device.type == "meta":
                break  # no values to fill
        self.params[name] = stacked


def _prefix_axes(specs: dict) -> dict:
    return {k: (_prefix_axes(v) if isinstance(v, dict)
                else ("layers",) + tuple(v))
            for k, v in specs.items()}


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """f32 statistics, cast back to ``x.dtype``, *then* the gain (the
    reference's order: in bf16 the product rounds once, in bf16)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


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


def constrain(x: torch.Tensor, logical_axes: tuple) -> torch.Tensor:
    """Resolve ``x``'s sharding when inside a mesh context; ``x`` itself
    either way."""
    mesh = current_mesh()
    if mesh is None or not constraints_enabled():
        return x
    resolve_spec(logical_axes, x.shape, mesh)
    return x

"""Mixture-of-Experts FFN layer: a thin shell over ``repro_torch.moe``.

Counterpart of ``repro.models.moe``.  The dispatch engines live in the
expert-dispatch subsystem (``repro_torch.moe``); this module owns what is a
model-layer concern: parameter initialization, engine selection from
``MoEConfig.dispatch``, and the always-on shared experts (DeepSeek).

* ``dense``      -- the GShard one-hot-einsum baseline;
* ``iru_sorted`` -- the sort-engine pipeline;
* ``iru_hash``   -- the planned dispatch (``moe.dispatch.plan_dispatch``);
  it alone takes ragged microbatches (``n_live``), expert-parallel
  execution (``n_shards``, where the reference takes ``mesh``) and
  ``return_stats``.

The router always computes in f32.  A Switch-style load-balancing aux loss
is returned alongside.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import Initializer
from repro_torch.moe.dispatch import moe_dense, moe_hash, moe_sorted
from repro_torch.moe.ep import moe_hash_ep


def init_moe(it: Initializer, d_model: int, moe: MoEConfig,
             ffn_type: str) -> None:
    it.weight("router", (d_model, moe.n_experts), ("embed", "experts"),
              dtype=torch.float32)
    shape_i = (moe.n_experts, d_model, moe.d_ff)
    shape_o = (moe.n_experts, moe.d_ff, d_model)
    it.weight("wi", shape_i, ("experts", "embed", "moe_ffn"))
    if ffn_type == "swiglu":
        it.weight("wg", shape_i, ("experts", "embed", "moe_ffn"))
    it.weight("wo", shape_o, ("experts", "moe_ffn", "embed"))
    if moe.n_shared_experts:
        d_sh = moe.n_shared_experts * moe.d_ff
        it.weight("shared_wi", (d_model, d_sh), ("embed", "ffn"))
        if ffn_type == "swiglu":
            it.weight("shared_wg", (d_model, d_sh), ("embed", "ffn"))
        it.weight("shared_wo", (d_sh, d_model), ("ffn", "embed"))


def moe_ffn(params: dict, x: torch.Tensor, moe: MoEConfig, ffn_type: str,
            dispatch: str | None = None, *, n_live=None,
            n_shards: int | None = None, return_stats: bool = False):
    """x: (B, S, D) or (T, D). Routes through the configured dispatch engine
    and adds the always-on shared experts when configured.

    ``n_live`` (live-token count, a 0-d tensor or int) and ``n_shards``
    (expert-parallel execution over that many shards) need the planned
    ``iru_hash`` engine; so does ``return_stats``, which appends the plan's
    ``moe.stats.DispatchStats``.
    """
    dispatch = dispatch or moe.dispatch
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    stats = None
    if dispatch == "iru_hash":
        if n_shards is not None:
            if return_stats:
                raise ValueError(
                    "return_stats is not supported with expert-parallel "
                    "execution (n_shards=) yet")
            y, aux = moe_hash_ep(params, xf, moe, ffn_type,
                                 n_shards=n_shards, n_live=n_live)
        elif return_stats:
            y, aux, stats = moe_hash(params, xf, moe, ffn_type, n_live=n_live,
                                     return_stats=True)
        else:
            y, aux = moe_hash(params, xf, moe, ffn_type, n_live=n_live)
    elif n_live is not None or n_shards is not None or return_stats:
        raise ValueError(
            f"n_live/n_shards/return_stats need the planned engine "
            f"(dispatch='iru_hash'), got dispatch={dispatch!r}")
    elif dispatch == "iru_sorted":
        y, aux = moe_sorted(params, xf, moe, ffn_type)
    elif dispatch == "dense":
        y, aux = moe_dense(params, xf, moe, ffn_type)
    else:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    if moe.n_shared_experts:
        if ffn_type == "swiglu":
            h = F.silu(xf @ params["shared_wg"]) * (xf @ params["shared_wi"])
        else:
            h = F.gelu(xf @ params["shared_wi"], approximate="tanh")
        y = y + h @ params["shared_wo"]
    if return_stats:
        return y.reshape(shape), aux, stats
    return y.reshape(shape), aux

"""Expert-parallel execution of a hash-engine dispatch plan.

Counterpart of ``repro.moe.ep``.  The banked engine's geometry carries
over: experts stripe across partitions as ``expert % n_partitions`` (the
banked ``set % nP`` rule), and the capacity buffer is laid out
partition-major, ``[nP, E/nP, C, D]``, the engine's bank rows.  A shard
owns a block of ``nP / n_shards`` partitions and their experts' weights.

``n_shards`` takes the place of the reference's ``mesh``: it is the size
``d`` of the mesh's partition axis.  The port runs the shards in one
process on one device, as the partitioned pipeline does: the rows are
stacked ``[d, B*E/nP, C, D]`` and the row stage is one batched product over
them.  Each shard combines its own lanes (those whose expert it holds) into
a partial ``(T, D)`` output; the cross-shard combine is the sum of the
``d`` partials, through the int8-compressed all-reduce
(``dist/collectives.allreduce_int8``) when ``compress`` and ``d > 1``, else
an exact f32 sum.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.dist.collectives import allreduce_int8
from repro_torch.moe.dispatch import (_combine, _experts_ffn, _route,
                                      _scatter_rows, capacity, plan_dispatch)

_AXIS = "part"  # the reference mesh's partition axis, named in its errors


def moe_hash_ep(params: dict, x: torch.Tensor, moe: MoEConfig, ffn_type: str,
                *, n_shards: int, n_partitions: Optional[int] = None,
                n_live=None, compress: bool = True):
    """x: (T, D) -> (T, D). Hash-planned dispatch, experts over ``n_shards``.

    ``n_partitions`` defaults to ``n_shards``; it may exceed it (a shard
    then owns a block of ``nP / n_shards`` partitions) but must be
    divisible by it, and must divide ``n_experts``.
    """
    T, D = x.shape
    E = moe.n_experts
    C = capacity(T, moe)
    d = n_shards
    nP = n_partitions if n_partitions is not None else d
    if E % nP != 0:
        raise ValueError(f"n_experts={E} must split across {nP} partitions")
    if nP % d != 0:
        raise ValueError(
            f"n_partitions={nP} must be divisible by mesh axis "
            f"{_AXIS!r} size {d}")
    Eper = E // nP           # experts per partition
    B = nP // d              # partitions per shard (banked block)

    gates, experts, aux = _route(params, x, moe, n_live=n_live)
    plan = plan_dispatch(experts, gates, C, E, n_partitions=nP, n_live=n_live)

    # partition-major expert permutation: expert e lives in partition e % nP;
    # perm lists the experts partition-major, prow maps an expert to its row
    dev = x.device
    ar_e = torch.arange(E, dtype=torch.int32, device=dev)
    perm = torch.sort(ar_e % nP, stable=True).indices
    prow = torch.empty_like(ar_e).index_copy_(0, perm, ar_e)
    slot_p = torch.where(plan.keep, prow[plan.expert.long()] * C + plan.rank,
                         E * C)

    # bank rows: the partition-major capacity buffer, one block a shard
    rows = _scatter_rows(x.index_select(0, plan.src_tok.long()), slot_p,
                         E * C)
    pl = {"wi": params["wi"][perm], "wo": params["wo"][perm]}
    if ffn_type == "swiglu":
        pl["wg"] = params["wg"][perm]
    # the row stage of all d shards, batched: shard s holds rows
    # [s*B*Eper, (s+1)*B*Eper) of the partition-major layout
    out = _experts_ffn(pl, rows.reshape(d * B * Eper, C, D), ffn_type)
    # each lane belongs to the partial of the shard holding its expert
    home = plan.partition // B
    y_parts = _combine(out.reshape(E * C, D), slot_p, plan.keep, plan.gate,
                       home * T + plan.src_tok, d * T).reshape(d, T, D)

    if compress and d > 1:
        y = allreduce_int8(y_parts, d)                 # int8-compressed combine
    else:
        y = y_parts.sum(0)
    return y.to(x.dtype), aux

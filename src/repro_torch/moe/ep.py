"""Expert-parallel execution of a hash-engine dispatch plan.

Counterpart of ``repro.moe.ep``.  The banked engine's geometry carries
over: experts stripe across partitions as ``expert % n_partitions`` (the
banked ``set % nP`` rule), and the capacity buffer is laid out
partition-major, ``[nP, E/nP, C, D]``, the engine's bank rows.  A shard
owns a block of ``nP / n_shards`` partitions and their experts' weights.

The shards ``d`` (the reference mesh's partition axis) are laid out one of
two ways (``dist.collectives``):

* ``n_shards=d`` -- every shard in this process on one device;
* ``mesh=`` a group mesh (``launch.mesh.make_iru_mesh(nP, group=...)``) --
  one shard per rank: each rank plans the whole batch (replicated, as the
  reference does) and holds only its ``E/d`` experts' weights
  (:func:`shard_experts`).

One row stage runs over the shards held here (all ``d`` stacked, or this
rank's): their block of the capacity buffer, ``[held*B*E/nP, C, D]``, in
one batched product.  Each shard combines its own lanes (those whose expert it holds) into a
partial ``(T, D)`` output; the cross-shard combine is the sum of the ``d``
partials, through the int8-compressed all-reduce
(``dist/collectives.allreduce_int8``) when ``compress`` and ``d > 1``, else
an exact f32 sum (an ``all_reduce`` over a group).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.dist.collectives import (StackedShards, allreduce_int8,
                                          group_shards)
from repro_torch.moe.dispatch import (_combine, _experts_ffn, _route,
                                      _scatter_rows, capacity, plan_dispatch)

_AXIS = "part"  # the reference mesh's partition axis, named in its errors
_EXPERT_WEIGHTS = ("wi", "wg", "wo")


def partition_major(n_experts: int, n_partitions: int,
                    device=None) -> torch.Tensor:
    """The experts listed partition-major: expert ``e`` lives in partition
    ``e % n_partitions``; a shard holds a contiguous block of this list."""
    ar = torch.arange(n_experts, dtype=torch.int32, device=device)
    return torch.sort(ar % n_partitions, stable=True).indices


def shard_experts(params: dict, moe: MoEConfig, n_shards: int, shard: int,
                  n_partitions: Optional[int] = None) -> dict:
    """The layer's params as shard ``shard`` of ``n_shards`` holds them: the
    router whole, each expert weight cut to the shard's block of
    :func:`partition_major` rows, and ``"experts"`` naming them.  Takes
    numpy arrays (a memory map reads the block's rows alone) or tensors;
    carry numpy across with ``convert.params_from_numpy``."""
    nP = n_partitions if n_partitions is not None else n_shards
    per = moe.n_experts // n_shards
    ids = partition_major(moe.n_experts, nP)[shard * per:(shard + 1) * per]
    ids = ids.numpy().astype(np.int32)
    out = {k: (v[ids] if k in _EXPERT_WEIGHTS else v)
           for k, v in params.items()}
    out["experts"] = ids
    return out


def moe_hash_ep(params: dict, x: torch.Tensor, moe: MoEConfig, ffn_type: str,
                *, n_shards: Optional[int] = None, mesh=None,
                n_partitions: Optional[int] = None, n_live=None,
                compress: bool = True):
    """x: (T, D) -> (T, D). Hash-planned dispatch, experts over ``n_shards``
    stacked shards or over the ranks of a group ``mesh``.

    ``n_partitions`` defaults to the shard count; it may exceed it (a shard
    then owns a block of ``nP / d`` partitions) but must be divisible by
    it, and must divide ``n_experts``.  Over a group, ``params`` are this
    rank's (:func:`shard_experts`); ``x`` is the whole batch on every rank,
    and every rank gets the whole output.
    """
    if (n_shards is None) == (mesh is None):
        raise TypeError("moe_hash_ep takes n_shards (stacked shards) or a "
                        "group mesh, not both")
    shards = (StackedShards(n_shards) if mesh is None
              else group_shards(mesh, _AXIS))
    T, D = x.shape
    E = moe.n_experts
    C = capacity(T, moe)
    d = shards.n_shards
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

    # partition-major expert permutation; prow maps an expert to its row
    dev = x.device
    perm = partition_major(E, nP, dev)
    ar_e = torch.arange(E, dtype=torch.int32, device=dev)
    prow = torch.empty_like(ar_e).index_copy_(0, perm, ar_e)
    slot_p = torch.where(plan.keep, prow[plan.expert.long()] * C + plan.rank,
                         E * C)

    # the held shards' experts: shard s holds rows [s*B*Eper, (s+1)*B*Eper)
    # of the partition-major layout (stacked: every shard, so all of them)
    held, per = shards.held, B * Eper
    ids = perm[held.start * per:held.stop * per]
    names = _EXPERT_WEIGHTS if ffn_type == "swiglu" else ("wi", "wo")
    if mesh is None:
        pl = {k: params[k][ids] for k in names}
    else:
        cut = params.get("experts")
        if cut is None or not torch.equal(
                torch.as_tensor(cut, device=dev).long(), ids.long()):
            raise ValueError(
                f"over a group mesh, params hold rank {shards.rank}'s "
                f"experts {ids.tolist()}: cut them with "
                f"moe.ep.shard_experts")
        pl = {k: params[k] for k in names}

    # bank rows: the held block of the partition-major capacity buffer
    lo, n_rows = held.start * per * C, len(held) * per * C
    mine = plan.keep & (slot_p >= lo) & (slot_p < lo + n_rows)
    slot = torch.where(mine, slot_p - lo, n_rows)
    rows = _scatter_rows(x.index_select(0, plan.src_tok.long()), slot, n_rows)
    # the row stage of the held shards, batched
    out = _experts_ffn(pl, rows.reshape(len(held) * per, C, D), ffn_type)
    # each lane belongs to the partial of the shard holding its expert
    dst = torch.where(mine, (plan.partition // B - held.start) * T, 0)
    y_parts = _combine(out.reshape(n_rows, D), slot, mine, plan.gate,
                       dst + plan.src_tok, len(held) * T
                       ).reshape(len(held), T, D)

    if compress and d > 1:
        y = allreduce_int8(y_parts, n_shards, mesh=mesh)  # int8 combine
    else:
        y = shards.sum(y_parts)
    return y.to(x.dtype), aux

"""Irregular-accesses Reorder Unit: the sort engine.

Counterpart of ``repro.core.iru``.  The paper's ``configure_iru`` /
``load_iru`` pair becomes one transform::

    stream = iru_reorder(indices, secondary, config=IRUConfig(...))

``stream.indices`` is the reordered index vector, ``stream.secondary`` the
co-reordered (and merged) payload, ``stream.positions`` the original lane of
each element (int32) and ``stream.active`` the ``load_iru`` flag (False for
lanes merged out).

This slice ports ``mode="sort"``: a stable sort by index, so equal indices
are adjacent and block grouping is perfect; the merge goes through
``core.filter.merge_sorted`` (kernel B2 on CUDA tensors).  ``mode="hash"``
(the batched hash engine with kernel B3), the host oracle ``"hash_ref"`` and
streaming windows (``window_elems``) come with the next slice.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, NamedTuple, Optional

import torch

from repro_torch.core import filter as filt

Mode = Literal["sort", "hash", "hash_ref"]
_INT32_MAX = torch.iinfo(torch.int32).max
_NEXT_SLICE = ("is not ported yet: the hash engine, its oracle and streaming "
               "windows come with the next slice of the port (kernel B3)")


@dataclasses.dataclass(frozen=True)
class IRUConfig:
    """``configure_iru`` parameters of the sort engine.

    ``filter_op`` enables the merge datapath; ``compact`` groups the
    merged-out lanes at the tail.  The sort engine keys on the raw index, so
    the reference's block geometry (``target_elem_bytes``, ``block_bytes``)
    arrives with the hash engine that reads it.
    """

    mode: Mode = "sort"
    filter_op: Optional[filt.FilterOp] = None
    compact: bool = True
    window_elems: Optional[int] = None


class IRUStream(NamedTuple):
    """Reordered irregular-access stream (the ``load_iru`` reply)."""

    indices: torch.Tensor     # int32[n] reordered indices
    secondary: torch.Tensor   # payload co-reordered / merged, [n] or [n, k]
    positions: torch.Tensor   # int32[n] original position of each element
    active: torch.Tensor      # bool[n]  False => merged/filtered out


def iru_reorder(
    indices: torch.Tensor,
    secondary: torch.Tensor | None = None,
    *,
    config: IRUConfig = IRUConfig(),
    n_live: torch.Tensor | int | None = None,
    kernels: bool = True,
) -> IRUStream:
    """Reorder (and optionally merge) an irregular-access index stream.

    ``n_live`` (a 0-d tensor or int, never a shape) makes the stream ragged:
    only the first ``n_live`` lanes are real.  Dead lanes sort to the tail,
    stay inactive, keep their original values and never join a run.
    ``kernels=False`` merges through the plain version on any device (the
    plain path a card run is held against).
    """
    if config.mode in ("hash", "hash_ref"):
        raise NotImplementedError(f"IRU mode {config.mode!r} {_NEXT_SLICE}")
    if config.mode != "sort":
        raise ValueError(f"unknown IRU mode {config.mode!r}")
    if config.window_elems is not None:
        raise NotImplementedError(f"window_elems {_NEXT_SLICE}")
    indices = indices.to(torch.int32)
    n = indices.shape[0]
    if secondary is None:
        secondary = torch.zeros(n, dtype=torch.float32, device=indices.device)
    if secondary.dim() not in (1, 2) or secondary.shape[0] != n:
        raise ValueError(f"secondary must be [n] or [n, k] with n={n}, got "
                         f"{tuple(secondary.shape)}")
    stream = _sort_reorder(indices, secondary, config, n_live, kernels)
    if config.compact and config.filter_op is not None:
        act, idx, sec, pos = filt.compact(stream.active, stream.indices,
                                          stream.secondary, stream.positions)
        stream = IRUStream(idx, sec, pos, act)
    return stream


def _sort_reorder(indices: torch.Tensor, secondary: torch.Tensor,
                  cfg: IRUConfig, n_live: torch.Tensor | int | None,
                  kernels: bool) -> IRUStream:
    # A stable sort on the index groups equal memory blocks AND makes
    # duplicates adjacent for the merge.  Ragged streams sort dead lanes to
    # the tail on a sentinel key (live indices are node ids < INT32_MAX).
    n = indices.shape[0]
    if n_live is None:
        live = None
        skey = indices
    else:
        lim = torch.as_tensor(n_live, dtype=torch.int32,
                              device=indices.device).clamp(0, n)
        live = torch.arange(n, dtype=torch.int32, device=indices.device) < lim
        skey = torch.where(live, indices, _INT32_MAX)
    order = torch.sort(skey, stable=True).indices
    idx = indices[order]
    sec = secondary[order]
    pos = order.to(torch.int32)
    live_s = None if live is None else live[order]
    if cfg.filter_op is None:
        active = (torch.ones(n, dtype=torch.bool, device=indices.device)
                  if live_s is None else live_s)
        return IRUStream(idx, sec, pos, active)
    from repro_torch.kernels.segment_merge.ref import segment_merge_ref

    merge = filt.merge_sorted if kernels else segment_merge_ref
    merged, survivors = merge(idx, sec, cfg.filter_op, live_s)
    return IRUStream(idx, merged, pos, survivors)


def _merged_scatter(target, indices, values, config, op):
    from repro_torch.core.pipeline import _scatter  # local: avoid a cycle

    cfg = dataclasses.replace(config or IRUConfig(), filter_op=op)
    stream = iru_reorder(indices, values, config=cfg)
    return _scatter(target, stream.indices, stream.secondary, stream.active,
                    op)


def iru_scatter_add(target: torch.Tensor, indices: torch.Tensor,
                    values: torch.Tensor, *,
                    config: IRUConfig | None = None) -> torch.Tensor:
    """PageRank pattern (Fig. 10): merged ``atomicAdd`` into ``target``."""
    return _merged_scatter(target, indices, values, config, "add")


def iru_scatter_min(target: torch.Tensor, indices: torch.Tensor,
                    values: torch.Tensor, *,
                    config: IRUConfig | None = None) -> torch.Tensor:
    """SSSP pattern (Fig. 9): merged ``atomicMin`` into ``target``."""
    return _merged_scatter(target, indices, values, config, "min")

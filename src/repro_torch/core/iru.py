"""Irregular-accesses Reorder Unit: the sort and hash engines.

Counterpart of ``repro.core.iru``.  The paper's ``configure_iru`` /
``load_iru`` pair becomes one transform::

    stream = iru_reorder(indices, secondary, config=IRUConfig(...))

``stream.indices`` is the reordered index vector, ``stream.secondary`` the
co-reordered (and merged) payload, ``stream.positions`` the original lane of
each element (int32) and ``stream.active`` the ``load_iru`` flag (False for
lanes merged out).

Three engines:

* ``mode="sort"`` -- a stable sort by index, so equal indices are adjacent
  and block grouping is perfect (the "infinite patience" upper bound); the
  merge goes through ``core.filter.merge_sorted`` (kernel B2 on CUDA
  tensors).
* ``mode="hash"`` -- the paper's bounded single pass: a direct-mapped hash
  of ``num_sets`` sets x ``slots`` slots keyed on the memory-block id,
  flush on full, merge on duplicate.  ``kernels.iru_reorder.ops.hash_reorder``
  runs it: kernel B3 on CUDA tensors, the batched plain version
  (``kernels/iru_reorder/batched.py``) on CPU tensors or with
  ``kernels=False``.  ``round_cap`` arms the dense fallback for streams
  that hammer a few sets (plain version only).
* ``mode="hash_ref"`` -- the numpy oracle (``kernels/iru_reorder/ref.py``)
  on the host, with the same semantics.

Streaming windows (``window_elems``) and the banked geometry
(``n_partitions``, ``n_banks``) come with later slices of the port.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Literal, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import filter as filt
from repro_torch.core.coalescing import BLOCK_BYTES

Mode = Literal["sort", "hash", "hash_ref"]
_INT32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class IRUConfig:
    """``configure_iru`` parameters.

    ``target_elem_bytes`` and ``block_bytes`` fix how indices map to memory
    blocks, the hash engine's key (the sort engine keys on the raw index).
    ``filter_op`` enables the merge datapath; ``compact`` groups the sort
    engine's merged-out lanes at the tail (the hash engines emit them there
    already).  ``num_sets`` x ``slots`` is the hash geometry; ``round_cap``
    bounds the hash engine's occupancy rounds (see
    ``kernels/iru_reorder/batched.py``).
    """

    target_elem_bytes: int = 4
    block_bytes: int = BLOCK_BYTES
    mode: Mode = "sort"
    filter_op: Optional[filt.FilterOp] = None
    compact: bool = True
    num_sets: int = 1024
    slots: int = 32
    round_cap: Optional[int] = None
    window_elems: Optional[int] = None

    def __post_init__(self):
        if self.num_sets < 1 or self.slots < 1:
            raise ValueError(f"num_sets={self.num_sets} and "
                             f"slots={self.slots} must be >= 1")
        if self.round_cap is not None and self.round_cap < 1:
            raise ValueError(f"round_cap must be >= 1, got {self.round_cap}")


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
    tag_table: torch.Tensor | None = None,
    kernels: bool = True,
) -> IRUStream:
    """Reorder (and optionally merge) an irregular-access index stream.

    ``n_live`` (a 0-d tensor or int, never a shape) makes the stream ragged:
    only the first ``n_live`` lanes are real.  Dead lanes stay inactive,
    keep their original values and never join a run.
    ``filter_op="tagged"`` with ``tag_table`` (bool, True = the add family)
    merges each duplicate group under its index's family; ``hash_ref``
    refuses it.  ``kernels=False`` runs the plain versions of the kernels on
    any device (the plain path a card run is held against).
    """
    if config.mode not in ("sort", "hash", "hash_ref"):
        raise ValueError(f"unknown IRU mode {config.mode!r}")
    if config.window_elems is not None:
        raise NotImplementedError(
            "window_elems (streaming windows) is not ported yet: it comes "
            "with a later slice of the port")
    if (config.filter_op == "tagged") != (tag_table is not None):
        raise ValueError("filter_op='tagged' and tag_table go together")
    indices = indices.to(torch.int32)
    n = indices.shape[0]
    if secondary is None:
        secondary = torch.zeros(n, dtype=torch.float32, device=indices.device)
    if secondary.dim() not in (1, 2) or secondary.shape[0] != n:
        raise ValueError(f"secondary must be [n] or [n, k] with n={n}, got "
                         f"{tuple(secondary.shape)}")
    if config.mode == "hash_ref":
        if tag_table is not None:
            raise NotImplementedError(
                "the hash_ref numpy oracle models single-family merges; use "
                "mode='sort' or 'hash' for the fused tagged datapath")
        out = _hash_ref_host(indices.cpu().numpy(), secondary.cpu().numpy(),
                             config, None if n_live is None else int(n_live))
        return IRUStream(*(torch.from_numpy(a).to(indices.device)
                           for a in out))
    if config.mode == "hash":
        from repro_torch.kernels.iru_reorder import ops as hash_ops

        # the hash engines emit survivors at the front and merged-out lanes
        # at the tail already, so there is nothing to compact
        return hash_ops.hash_reorder(
            indices, secondary, num_sets=config.num_sets, slots=config.slots,
            elem_bytes=config.target_elem_bytes,
            block_bytes=config.block_bytes, filter_op=config.filter_op,
            round_cap=config.round_cap, n_live=n_live, tag_table=tag_table,
            kernels=kernels)
    stream = _sort_reorder(indices, secondary, config, n_live, tag_table,
                           kernels)
    if config.compact and config.filter_op is not None:
        act, idx, sec, pos = filt.compact(stream.active, stream.indices,
                                          stream.secondary, stream.positions)
        stream = IRUStream(idx, sec, pos, act)
    return stream


def _hash_ref_host(indices: np.ndarray, secondary: np.ndarray,
                   config: IRUConfig, n_live: int | None = None):
    """numpy oracle of the hash engine (``ref.hash_reorder_ref_flat``: the
    plain hash, or its dense fallback past a ``round_cap``), composed with
    the ragged layout (``ref.ragged_oracle``) when ``n_live`` is given."""
    from repro_torch.kernels.iru_reorder.ref import (hash_reorder_ref_flat,
                                                     ragged_oracle)

    fn = functools.partial(
        hash_reorder_ref_flat, num_sets=config.num_sets, slots=config.slots,
        elem_bytes=config.target_elem_bytes, block_bytes=config.block_bytes,
        filter_op=config.filter_op, round_cap=config.round_cap)
    if n_live is None:
        return fn(indices, secondary)
    return ragged_oracle(fn, indices, secondary, n_live)


def _sort_reorder(indices: torch.Tensor, secondary: torch.Tensor,
                  cfg: IRUConfig, n_live: torch.Tensor | int | None,
                  tag_table: torch.Tensor | None,
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
    tags = None
    if cfg.filter_op == "tagged":
        # tags re-derive from the permuted index frame (real values on every
        # lane, dead ones included, so every lookup stays in range)
        tags = tag_table[idx.long().clamp(0, tag_table.shape[0] - 1)]
    from repro_torch.kernels.segment_merge.ref import segment_merge_ref

    merge = filt.merge_sorted if kernels else segment_merge_ref
    merged, survivors = merge(idx, sec, cfg.filter_op, live_s, tags)
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

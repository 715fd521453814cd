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
  runs it: kernel B3 on CUDA tensors, the plain versions
  (``kernels/iru_reorder/batched.py``, ``banked.py``) on CPU tensors or with
  ``kernels=False``.  ``n_partitions > 1`` is the banked geometry (sets
  stripe as ``set % n_partitions``, each partition reorders its sub-stream
  on its own, the stream emits partition-major); ``round_cap`` arms the
  dense fallback for streams that hammer a few sets.
* ``mode="hash_ref"`` -- the numpy oracle (``kernels/iru_reorder/ref.py``)
  on the host, with the same semantics.

Streaming windows (``window_elems=w``) model the hardware's bounded
lookahead: the stream is reordered in independent windows of ``w`` lanes
(the last one ragged), so duplicates merge only within a window.  On CUDA
tensors the hash engine reorders every window in one launch of B3's
windowed body; elsewhere ``_windowed_reorder`` loops over the windows.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Literal, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import filter as filt
from repro_torch.core.coalescing import BLOCK_BYTES
from repro_torch.device import resolve_device

Mode = Literal["sort", "hash", "hash_ref"]
_INT32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class IRUConfig:
    """``configure_iru`` parameters.

    ``target_elem_bytes`` and ``block_bytes`` fix how indices map to memory
    blocks, the hash engine's key (the sort engine keys on the raw index).
    ``filter_op`` enables the merge datapath; ``compact`` groups the sort
    engine's merged-out lanes at the tail (the hash engines emit them there
    already).  ``num_sets`` x ``slots`` is the hash geometry, striped over
    ``n_partitions`` partitions of ``n_banks`` banks (the paper: 1024 x 32
    over 4 x 2).  ``n_banks`` is physical parallelism with no effect on the
    stream; it only constrains the geometry (``num_sets`` splits evenly into
    ``n_partitions * n_banks``).  ``round_cap`` bounds a (partition's)
    occupancy rounds: past it the stream takes the dense sort-merge
    fallback (see ``kernels/iru_reorder/batched.py``).  ``window_elems``
    reorders independent windows of that many lanes.

    The reference's ``engine``, ``interpret`` and ``bank_map`` have no
    counterpart: the port's one ``kernels=`` switch chooses between a
    kernel and its plain version, and ``bank_map`` chose between two equal
    JAX realizations.  A mesh is no field of the config in either package:
    banks shard over the ranks of a process group through
    ``kernels.iru_reorder.ops.hash_reorder(..., mesh=)`` (a group mesh from
    ``launch.mesh.make_iru_mesh(P, group=...)``, one block of partitions a
    rank).
    """

    target_elem_bytes: int = 4
    block_bytes: int = BLOCK_BYTES
    mode: Mode = "sort"
    filter_op: Optional[filt.FilterOp] = None
    compact: bool = True
    num_sets: int = 1024
    slots: int = 32
    n_partitions: int = 1
    n_banks: int = 2
    round_cap: Optional[int] = None
    window_elems: Optional[int] = None

    def __post_init__(self):
        if self.num_sets < 1 or self.slots < 1:
            raise ValueError(f"num_sets={self.num_sets} and "
                             f"slots={self.slots} must be >= 1")
        if self.n_partitions < 1 or self.n_banks < 1:
            raise ValueError(
                f"n_partitions/n_banks must be >= 1, got "
                f"{self.n_partitions}/{self.n_banks}")
        if self.num_sets % (self.n_partitions * self.n_banks) != 0:
            raise ValueError(
                f"num_sets={self.num_sets} must split evenly across "
                f"{self.n_partitions} partitions x {self.n_banks} banks")
        if self.round_cap is not None and self.round_cap < 1:
            raise ValueError(f"round_cap must be >= 1, got {self.round_cap}")
        if self.window_elems is not None and self.window_elems < 1:
            raise ValueError(
                f"window_elems must be >= 1, got {self.window_elems}")

    @property
    def bank_parallelism(self) -> int:
        """Modeled parallel insert lanes (partitions x banks, paper §3.2)."""
        return self.n_partitions * self.n_banks


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
    keep their original values and never join a run; under windows each
    window holds ``clip(n_live - i*w, 0, w)`` live lanes.
    ``filter_op="tagged"`` with ``tag_table`` (bool, True = the add family)
    merges each duplicate group under its index's family; ``hash_ref``
    refuses it.  ``kernels=False`` runs the plain versions of the kernels on
    any device (the plain path a card run is held against).
    """
    if config.mode not in ("sort", "hash", "hash_ref"):
        raise ValueError(f"unknown IRU mode {config.mode!r}")
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
    if config.mode == "sort" and config.window_elems is not None:
        return _windowed_reorder(indices, secondary, config, n_live,
                                 tag_table, kernels)
    return _reorder_window(indices, secondary, config, n_live, tag_table,
                           kernels)


def _reorder_window(indices: torch.Tensor, secondary: torch.Tensor,
                    config: IRUConfig, n_live, tag_table,
                    kernels: bool) -> IRUStream:
    """One window (or the whole stream) through the configured engine.  In
    hash mode ``config.window_elems`` rides along: the wrapper reorders every
    window in one launch on CUDA tensors, or loops ``_windowed_reorder``."""
    if config.mode == "hash":
        from repro_torch.kernels.iru_reorder import ops as hash_ops

        # the hash engines emit survivors at the front and merged-out lanes
        # at the tail already, so there is nothing to compact
        return hash_ops.hash_reorder(
            indices, secondary, num_sets=config.num_sets, slots=config.slots,
            elem_bytes=config.target_elem_bytes,
            block_bytes=config.block_bytes, filter_op=config.filter_op,
            round_cap=config.round_cap, n_partitions=config.n_partitions,
            window_elems=config.window_elems, n_live=n_live,
            tag_table=tag_table, kernels=kernels)
    stream = _sort_reorder(indices, secondary, config, n_live, tag_table,
                           kernels)
    if config.compact and config.filter_op is not None:
        act, idx, sec, pos = filt.compact(stream.active, stream.indices,
                                          stream.secondary, stream.positions)
        stream = IRUStream(idx, sec, pos, act)
    return stream


def _windowed_reorder(indices: torch.Tensor, secondary: torch.Tensor,
                      config: IRUConfig, n_live, tag_table,
                      kernels: bool) -> IRUStream:
    """Bounded-lookahead streaming, the plain way: independent windows of
    ``w`` lanes (the last one ragged) through ``_reorder_window`` one at a
    time, positions offset by each window's start, concatenated.

    A ragged stream's window ``i`` holds ``clip(n_live - i*w, 0, w)`` live
    lanes (the live lanes are a global prefix); a fully dead window is the
    identity layout (original values, stream-order positions, all
    inactive), as in the reference's ``lax.cond``.  ``n_live`` is read on
    the host once.
    """
    w = config.window_elems
    sub = dataclasses.replace(config, window_elems=None)
    n = indices.shape[0]
    dev = indices.device
    m = None if n_live is None else int(torch.as_tensor(n_live).clamp(0, n))
    parts = []
    for s0 in range(0, n, w):
        idx_w, sec_w = indices[s0:s0 + w], secondary[s0:s0 + w]
        span = idx_w.shape[0]
        live_w = None if m is None else min(max(m - s0, 0), span)
        if live_w == 0:
            out = IRUStream(idx_w, sec_w,
                            torch.arange(span, dtype=torch.int32, device=dev),
                            torch.zeros(span, dtype=torch.bool, device=dev))
        else:
            out = _reorder_window(idx_w, sec_w, sub, live_w, tag_table,
                                  kernels)
        parts.append(out._replace(positions=out.positions + s0))
    if not parts:
        return IRUStream(indices, secondary,
                         torch.zeros(0, dtype=torch.int32, device=dev),
                         torch.zeros(0, dtype=torch.bool, device=dev))
    return IRUStream(*(torch.cat([p[i] for p in parts]) for i in range(4)))


def _hash_ref_host(indices: np.ndarray, secondary: np.ndarray,
                   config: IRUConfig, n_live: int | None = None):
    """numpy oracle of the hash engine, window by window.

    Each window runs ``ref.hash_reorder_ref_vec`` or, with
    ``n_partitions > 1`` or a ``round_cap``, the partitioned and cap-aware
    ``ref.hash_reorder_ref_banked``, composed with the ragged layout
    (``ref.ragged_oracle``) when ``n_live`` is given, its positions offset by
    the window's start.
    """
    from repro_torch.kernels.iru_reorder.ref import (
        hash_reorder_ref_banked, hash_reorder_ref_vec, ragged_oracle)

    n = indices.shape[0]
    if n == 0:
        return (np.zeros(0, np.int32),
                np.zeros((0,) + secondary.shape[1:], secondary.dtype),
                np.zeros(0, np.int32), np.zeros(0, bool))
    w = config.window_elems if config.window_elems is not None else n
    kw = dict(num_sets=config.num_sets, slots=config.slots,
              elem_bytes=config.target_elem_bytes,
              block_bytes=config.block_bytes, filter_op=config.filter_op)
    if config.n_partitions > 1 or config.round_cap is not None:
        fn = functools.partial(hash_reorder_ref_banked,
                               n_partitions=config.n_partitions,
                               round_cap=config.round_cap, **kw)
    else:
        fn = functools.partial(hash_reorder_ref_vec, **kw)
    outs = []
    for s0 in range(0, n, w):
        idx_w, sec_w = indices[s0:s0 + w], secondary[s0:s0 + w]
        if n_live is None:
            oi, osec, opos, oact = fn(idx_w, sec_w)
        else:
            live_w = int(np.clip(n_live - s0, 0, idx_w.shape[0]))
            oi, osec, opos, oact = ragged_oracle(fn, idx_w, sec_w, live_w)
        outs.append((oi, osec, (opos + np.int32(s0)).astype(np.int32), oact))
    if len(outs) == 1:
        return outs[0]
    return tuple(np.concatenate([o[i] for o in outs], axis=0)
                 for i in range(4))


def reorder_frontier(indices, secondary=None, *, config: IRUConfig,
                     device: str | torch.device | None = None):
    """Host-side streaming entry point for frontier-driven apps.

    Takes numpy (or anything array-like) and returns numpy
    ``(indices, secondary, positions, active)``.  float64 / int64 payloads
    become float32 / int32 first, as in the reference (x64 off), so the
    result's dtype does not depend on the engine.  ``hash_ref`` stays on
    the host; the other engines run on ``device`` (default: the card).
    """
    idx = np.asarray(indices, np.int32)
    sec = (np.zeros(idx.shape, np.float32) if secondary is None
           else np.asarray(secondary))
    if sec.dtype == np.float64:
        sec = sec.astype(np.float32)
    elif sec.dtype == np.int64:
        sec = sec.astype(np.int32)
    if config.mode == "hash_ref":
        return _hash_ref_host(idx, sec, config)
    dev = resolve_device(device)
    stream = iru_reorder(torch.as_tensor(np.ascontiguousarray(idx)).to(dev),
                         torch.as_tensor(np.ascontiguousarray(sec)).to(dev),
                         config=config)
    return tuple(x.cpu().numpy() for x in stream)


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


def load_iru_gather(table: torch.Tensor, indices: torch.Tensor, *,
                    config: IRUConfig = IRUConfig(),
                    kernels: bool = True) -> tuple[torch.Tensor, IRUStream]:
    """BFS pattern (Fig. 8): reorder ``indices``, then gather ``table`` rows.

    Returns the rows *in the reordered order* and the stream, so the caller
    can correlate them through ``stream.positions``.  The gather is a plain
    index (the reference's ``jnp.take``); indices must lie in the table.
    """
    stream = iru_reorder(indices, config=config, kernels=kernels)
    return table[stream.indices.long()], stream


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

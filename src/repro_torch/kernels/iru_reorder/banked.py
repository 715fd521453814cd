"""Plain PyTorch version of kernel B3's banked emission: the multi-partition
IRU hash engine (paper §3.2: 4 partitions x 2 banks).

Counterpart of ``repro.kernels.iru_reorder.banked``, ported function for
function on top of the flat engine's machinery (``batched.py``), with the
same branch decisions:

* one stable sort by ``(partition, set, stream order)`` buckets the stream
  partition-major (``partition = set % n_partitions``);
* elements scatter into ``[n_partitions, capacity]`` bank rows, set-sorted,
  padded with inert lanes;
* each row reorders on its own (the reference's ``lax.map``; here a Python
  loop over rows), so its occupancy-round loop trips only as often as that
  partition needs and each partition applies its own ``round_cap`` fallback;
* survivors emit partition-major: partition fronts first, filtered tails
  last, as ``ref.hash_reorder_ref_banked``.

A stream whose partition counts exceed ``ref.partition_capacity`` (taken on
the live count) bypasses banking through the flat engine, and
``n_partitions=1`` *is* the flat engine.  Ragged streams (``n_live``) first
try the two-generation closed form.  The reference's ``lax.cond`` /
``lax.switch`` become host reads of the branch predicate.  Its ``mesh``
(``shard_map`` over devices) and ``bank_map`` (``lax.map`` or ``vmap``, the
same result) have no counterpart here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.iru_reorder.batched import (
    _I32, _INT32_MAX, _ar, _assemble, _cumsum, _lane_tags, _reorder_presorted,
    _two_gen_emit, _two_gen_fits, _two_gen_plan, hash_reorder_batched,
    hash_set)
from repro_torch.kernels.iru_reorder.ref import partition_capacity


def _row_reorder(row, *, num_sets: int, slots: int, filter_op: Optional[str],
                 round_cap: Optional[int],
                 tag_table: Optional[torch.Tensor] = None):
    """Reorder one partition's (padded, set-sorted) bank row.  Padding lanes
    carry index -1, which clips into the tag table but is never consumed."""
    I, V, Pos, S, valid = row
    filtered, band, key, acc = _reorder_presorted(
        I, V, Pos, S, valid, num_sets=num_sets, slots=slots,
        filter_op=filter_op, round_cap=round_cap,
        tags=_lane_tags(tag_table, I))
    oi, osec, opos, oact = _assemble(I, V, Pos, valid, filtered, band, key,
                                     acc)
    n_filt = filtered.sum(dtype=_I32)
    n_surv = (~filtered & valid).sum(dtype=_I32)
    return oi, osec, opos, oact, n_surv, n_filt


def _place(n: int, slot: torch.Tensor, vals: torch.Tensor,
           fill: torch.Tensor) -> torch.Tensor:
    """``fill.at[slot].set(vals, mode="drop")`` for ``slot`` in ``[0, n]``
    (``n`` is the dropped sink)."""
    buf = torch.cat([fill, fill[:1]])
    buf[slot.long()] = vals
    return buf[:n]


def hash_reorder_banked(
    indices: torch.Tensor,
    secondary: torch.Tensor,
    *,
    num_sets: int = 1024,
    slots: int = 32,
    elem_bytes: int = 4,
    block_bytes: int = 128,
    filter_op: Optional[str] = None,
    n_partitions: int = 4,
    round_cap: Optional[int] = None,
    n_live: torch.Tensor | int | None = None,
    tag_table: Optional[torch.Tensor] = None,
):
    """Banked hash reorder; stream-identical to ``ref.hash_reorder_ref_banked``.

    ``filter_op="tagged"`` with ``tag_table`` folds each duplicate group
    under its index's family, in every bank row.  ``n_live`` (a 0-d tensor
    or int, never a shape) makes the stream ragged: the banked oracle on the
    live prefix -- partition fronts, then the dead lanes in stream order
    (inactive, original values), then the partition tails.  Dead lanes take
    a sentinel partition, so the bank counts, the capacity bypass
    (``partition_capacity`` on the live count) and every row's round bound
    see only the prefix.

    Returns ``(out_idx, out_sec, out_pos, out_act)``.
    """
    indices = indices.to(_I32)
    n = indices.shape[0]
    dev = indices.device
    if (filter_op == "tagged") != (tag_table is not None):
        raise ValueError("filter_op='tagged' and tag_table go together")
    if n_partitions <= 1:
        return hash_reorder_batched(
            indices, secondary, num_sets=num_sets, slots=slots,
            elem_bytes=elem_bytes, block_bytes=block_bytes,
            filter_op=filter_op, round_cap=round_cap, n_live=n_live,
            tag_table=tag_table)
    if num_sets % n_partitions != 0:
        raise ValueError(f"num_sets={num_sets} must divide evenly into "
                         f"n_partitions={n_partitions}")
    if n == 0:
        return (indices, secondary, torch.zeros(0, dtype=_I32, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))

    nP = n_partitions
    C = partition_capacity(n, nP)
    epb = block_bytes // elem_bytes
    payload = tuple(secondary.shape[1:])

    sets = hash_set(torch.div(indices, epb, rounding_mode="floor"), num_sets)
    if n_live is None:
        live = None
        part = sets % nP
        cap_eff = C
    else:
        m_live = int(torch.as_tensor(n_live).clamp(0, n))
        live = _ar(n, dev) < m_live
        # sentinel partition: dead lanes never land in a bank row
        part = torch.where(live, sets % nP, nP).to(_I32)
        per = -(-m_live // nP)
        cap_eff = min(m_live, per + max(64, per // 4))
    cnt = torch.bincount(part.long(), minlength=nP + 1)[:nP].to(_I32)
    overflow = int(cnt.max()) > cap_eff

    def banked_fn():
        # partition-major, set-minor, stream-stable: the engine's one big
        # sort; dead lanes share one maximal key and sink in stream order
        skey = part * num_sets + (sets if live is None
                                  else torch.where(live, sets, num_sets))
        order = torch.argsort(skey, stable=True)
        S, I, V = sets[order], indices[order], secondary[order]
        Pos = order.to(_I32)
        Pa = part[order].long()
        part_start = torch.cat([cnt.new_zeros(1), _cumsum(cnt)])
        col = _ar(n, dev) - part_start[Pa.clamp(max=nP)]
        rc = (Pa.clamp(max=nP - 1), col.long())
        keep = Pa < nP  # dead lanes (partition nP) stay out of every row

        def rows(fill, vals, dtype):
            buf = torch.full((nP, C) + vals.shape[1:], fill, dtype=dtype,
                             device=dev)
            buf[rc[0][keep], rc[1][keep]] = vals[keep]
            return buf

        rI = rows(-1, I, _I32)
        rV = rows(0, V, secondary.dtype)
        rPos = rows(_INT32_MAX, Pos, _I32)
        rS = rows(num_sets, S, _I32)
        rValid = rows(False, torch.ones(n, dtype=torch.bool, device=dev),
                      torch.bool)
        outs = [_row_reorder((rI[p], rV[p], rPos[p], rS[p], rValid[p]),
                             num_sets=num_sets, slots=slots,
                             filter_op=filter_op, round_cap=round_cap,
                             tag_table=tag_table) for p in range(nP)]
        oi, osec, opos, oact = (torch.stack([o[k] for o in outs])
                                for k in range(4))
        m = torch.stack([o[4] for o in outs])
        f = torch.stack([o[5] for o in outs])
        # partition-major combine: fronts [0, sum m), tails [n - sum f, n)
        front_off = _cumsum(m) - m
        tail_off = _cumsum(f) - f
        cols = _ar(C, dev)[None, :]
        in_front = cols < m[:, None]
        in_tail = cols >= C - f[:, None]
        g = torch.where(in_front, front_off[:, None] + cols,
                        torch.where(in_tail,
                                    (n - f.sum(dtype=_I32)) + tail_off[:, None]
                                    + (cols - (C - f[:, None])), n)).reshape(-1)
        out_idx = _place(n, g, oi.reshape(-1), indices.new_zeros(n))
        out_sec = _place(n, g, osec.reshape((nP * C,) + payload),
                         secondary.new_zeros((n,) + payload))
        out_pos = _place(n, g, opos.reshape(-1), indices.new_zeros(n))
        out_act = _place(n, g, oact.reshape(-1),
                         torch.zeros(n, dtype=torch.bool, device=dev))
        if live is not None:
            # dead lanes fill the gap between the partition fronts and the
            # filtered tails, in stream order, with their original values
            live_s = live[order]
            dead_rank = _cumsum(~live_s) - 1
            gd = torch.where(live_s, n, m.sum(dtype=_I32) + dead_rank)
            out_idx = _place(n, gd, I, out_idx)
            out_sec = _place(n, gd, V, out_sec)
            out_pos = _place(n, gd, Pos, out_pos)
        return out_idx, out_sec, out_pos, out_act

    def flat_fn():
        # bank capacity exceeded: bypass banking, as the oracle does
        return hash_reorder_batched(
            indices, secondary, num_sets=num_sets, slots=slots,
            elem_bytes=elem_bytes, block_bytes=block_bytes,
            filter_op=filter_op, round_cap=round_cap, n_live=n_live,
            tag_table=tag_table)

    if overflow:
        return flat_fn()
    if live is not None and _two_gen_fits(n, num_sets):
        # ragged fast path: every live set within two occupancy generations
        # (and no partition past the round cap) is the closed form with
        # partition-major computed emission
        ok, plan = _two_gen_plan(
            indices, secondary, live, sets, n_partitions=nP,
            num_sets=num_sets, slots=slots, filter_op=filter_op,
            round_cap=round_cap, tag_table=tag_table)
        if bool(ok):
            return _two_gen_emit(indices, secondary, plan)
    return banked_fn()

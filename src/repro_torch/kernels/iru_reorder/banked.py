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
``lax.switch`` become host reads of the branch predicate.  Its
``bank_map`` (``lax.map`` or ``vmap``, the same result) has no counterpart.

Its ``mesh`` (the row stage under ``shard_map``, partitions sharded over
the devices) is a group mesh here (``launch.mesh.make_iru_mesh(P,
group=...)``): each rank of a ``torch.distributed`` group reorders its own
block of bank rows, and one ``all_gather`` of the rows' outputs feeds the
partition-major combine.  The stream, the partition counts, the bypass and
the two-generation path stay replicated on every rank, as in the reference,
where only the row stage is inside ``shard_map``.
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


def bank_rows(mesh, n_partitions: int):
    """The shards of a group ``mesh`` over the bank rows and the block of
    partitions this rank reorders (rank ``r`` of ``W``: rows ``[r * P / W,
    (r + 1) * P / W)``, the reference's ``P(axis)`` sharding).  Raises for
    one partition (the reference's words), a mesh without a process group
    and ranks that do not divide the partitions."""
    from repro_torch.dist.collectives import group_shards

    if n_partitions <= 1:
        raise ValueError(
            "mesh sharding requires n_partitions > 1 (the mesh shards bank "
            "rows; a single partition has nothing to shard)")
    shards = group_shards(mesh)
    if n_partitions % shards.n_shards:
        raise ValueError(f"{shards.n_shards} ranks do not divide "
                         f"{n_partitions} partitions")
    per = n_partitions // shards.n_shards
    return shards, range(shards.rank * per, (shards.rank + 1) * per)


def gather_rows(shards, *rows):
    """Every rank's block ``[held, ...]`` of each of ``rows``, concatenated
    in rank order: ``[n_partitions, ...]`` (one ``all_gather`` each)."""
    out = []
    for x in rows:
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        got = shards.gather(wire[None]).flatten(0, 1)
        out.append(got.bool() if x.dtype == torch.bool else got)
    return out


def banks(indices: torch.Tensor, *, num_sets: int, n_partitions: int,
          epb: int, n_live):
    """Each lane's set and partition (``n_partitions`` for a dead lane),
    the live mask (None: no ``n_live``) and live count, the partition
    counts and the capacity past which the stream bypasses banking (on
    the live count)."""
    n, dev, nP = indices.shape[0], indices.device, n_partitions
    sets = hash_set(torch.div(indices, epb, rounding_mode="floor"), num_sets)
    if n_live is None:
        live, m_live = None, n
        part = sets % nP
        cap_eff = partition_capacity(n, nP)
    else:
        m_live = int(torch.as_tensor(n_live).clamp(0, n))
        live = _ar(n, dev) < m_live
        # sentinel partition: dead lanes never land in a bank row
        part = torch.where(live, sets % nP, nP).to(_I32)
        per = -(-m_live // nP)
        cap_eff = min(m_live, per + max(64, per // 4))
    cnt = torch.bincount(part.long(), minlength=nP + 1)[:nP].to(_I32)
    return sets, part, live, m_live, cnt, cap_eff


def emit_partition_major(indices, secondary, rows, m_live: int):
    """The banked stream from every partition's reordered bank row
    (``rows``: ``oi, osec, opos, oact [n_partitions, C, ...]`` with the
    survivors at ``[0, m)`` and the filtered tail at ``[C - f, C)``, and
    ``m, f [n_partitions]``): partition fronts, then the dead lanes
    ``[m_live, n)`` in stream order with their original values (inactive),
    then the partition tails."""
    oi, osec, opos, oact, m, f = rows
    n, dev = indices.shape[0], indices.device
    nP, C = oi.shape[:2]
    payload = tuple(secondary.shape[1:])
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
    if m_live < n:
        # the dead lanes fill the gap between the fronts and the tails
        gd = m.sum(dtype=_I32) + _ar(n - m_live, dev)
        out_idx = _place(n, gd, indices[m_live:], out_idx)
        out_sec = _place(n, gd, secondary[m_live:], out_sec)
        out_pos = _place(n, gd, _ar(n, dev)[m_live:], out_pos)
    return out_idx, out_sec, out_pos, out_act


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
    mesh=None,
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

    ``mesh`` (a group mesh, ``launch.mesh.make_iru_mesh(n_partitions,
    group=...)``) reorders only this rank's block of bank rows; every rank
    of the group calls with the same stream and gets the whole result.

    Returns ``(out_idx, out_sec, out_pos, out_act)``.
    """
    indices = indices.to(_I32)
    n = indices.shape[0]
    dev = indices.device
    if (filter_op == "tagged") != (tag_table is not None):
        raise ValueError("filter_op='tagged' and tag_table go together")
    shards, held = (None, range(n_partitions)) if mesh is None else (
        bank_rows(mesh, n_partitions))
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
    sets, part, live, m_live, cnt, cap_eff = banks(
        indices, num_sets=num_sets, n_partitions=nP,
        epb=block_bytes // elem_bytes, n_live=n_live)
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
        # the held block of bank rows; dead lanes (partition nP) and other
        # ranks' partitions stay out
        keep = (Pa >= held.start) & (Pa < held.stop)
        rc = ((Pa - held.start)[keep], col.long()[keep])

        def rows(fill, vals, dtype):
            buf = torch.full((len(held), C) + vals.shape[1:], fill,
                             dtype=dtype, device=dev)
            buf[rc] = vals[keep]
            return buf

        rI = rows(-1, I, _I32)
        rV = rows(0, V, secondary.dtype)
        rPos = rows(_INT32_MAX, Pos, _I32)
        rS = rows(num_sets, S, _I32)
        rValid = rows(False, torch.ones(n, dtype=torch.bool, device=dev),
                      torch.bool)
        outs = [_row_reorder((rI[r], rV[r], rPos[r], rS[r], rValid[r]),
                             num_sets=num_sets, slots=slots,
                             filter_op=filter_op, round_cap=round_cap,
                             tag_table=tag_table) for r in range(len(held))]
        out_rows = [torch.stack([o[k] for o in outs]) for k in range(6)]
        if shards is not None:
            out_rows = gather_rows(shards, *out_rows)
        return emit_partition_major(indices, secondary, out_rows, m_live)

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

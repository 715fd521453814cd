"""Plain PyTorch version of kernel B3: the batch-parallel IRU hash engine.

Counterpart of ``repro.kernels.iru_reorder.batched``, ported function for
function with the same branch decisions, so the same inputs take the same
branch in both packages.  On the card it is the plain version that kernel B3
(``iru_reorder.cu``) is held against; on the CPU it is what
``ops.hash_reorder`` runs.  (In this directory ``ref.py`` is the numpy
oracle, as in the reference.)

* block keys and hash sets are computed for the whole stream at once;
* one stable sort buckets elements per hash set (stream order kept inside
  each bucket);
* each set's life is a sequence of *occupancy rounds* -- residency periods
  between flushes.  A round ends when its ``slots``-th surviving element
  arrives (flush, emitted at that trigger's stream position) or at end of
  stream (drain, emitted in set order after every flush).  Without a filter
  op the round boundaries are ``rank // slots``.  With one, an element is
  filtered exactly when a same-index element already landed in the
  *current* round, so rounds are peeled by a loop whose body is vectorized
  across all sets (the reference's ``lax.while_loop``; here a Python loop
  with one ``.any()`` read per round);
* duplicates fold into one surviving leader per (set, index, round) group.

``round_cap`` is the hybrid fallback: when the a-priori round bound
``max_set ceil(n_set / slots)`` exceeds it, the stream takes the dense
sort-merge path (``ref.hash_reorder_ref_flat`` is its oracle).  Ragged
streams (``n_live``) first try the two-generation closed form
(``_two_gen_plan``) and fall back to the presorted machinery when its
exactness guard declines.  The reference's ``lax.cond`` / ``lax.switch``
branches become host reads of the branch predicate.

Output layout matches ``ref.hash_reorder_ref`` exactly: survivors at the
front in emission order, filtered elements at the tail in reverse detection
order; indices / positions / active are bit-identical, payloads agree up to
fp reduction order.  Payloads may be ``[n]`` or ``[n, k]``.
"""
from __future__ import annotations

from typing import Optional

import torch

# emission bands: front groups order by (band, local_key, stream pos)
BAND_FLUSH = 0   # key = stream position of the flush trigger
BAND_DRAIN = 1   # key = set id (dense path: index value)
BAND_PAD = 2     # padding / dead lanes
_BAND_FILTERED = 3  # assembly-internal: filtered close the tail

_INT32_MAX = torch.iinfo(torch.int32).max
_MIX = 2654435761  # Knuth multiplicative hash constant
_I32 = torch.int32


def hash_set(key: torch.Tensor, num_sets: int) -> torch.Tensor:
    """``(uint32(key) * 2654435761) ^ (>> 16) % num_sets`` as int32.

    Computed in int64 on 16-bit halves of the key, so no product overflows.
    """
    k = key.to(torch.int64) & 0xFFFFFFFF
    h = ((k & 0xFFFF) * _MIX + ((((k >> 16) * _MIX) & 0xFFFF) << 16)) \
        & 0xFFFFFFFF
    h = h ^ (h >> 16)
    return (h % num_sets).to(_I32)


def _ar(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=device)


def _pex(mask: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Broadcast a lane mask across trailing payload dims of ``ref``."""
    return mask.reshape(mask.shape + (1,) * (ref.dim() - mask.dim()))


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(_I32), 0, dtype=_I32)


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def _lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort``: the LAST key is primary; every sort is stable."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _scatter(size: int, idx: torch.Tensor, vals: torch.Tensor, reduce: str,
             init) -> torch.Tensor:
    """``jnp.full(size, init).at[idx].<reduce>(vals, mode="drop")``.

    Lanes that cannot change the result -- a target outside ``[0, size)``,
    or the value ``init`` itself (``reduce`` only moves the buffer away from
    ``init``) -- go to sink slots of their own past the end, which are
    sliced off: on the card, many lanes on one address serialise.
    """
    lanes = idx.shape[0]
    idx = idx.long()
    keep = (idx >= 0) & (idx < size) & (vals != init)
    idx = torch.where(keep, idx, size + torch.arange(lanes, device=idx.device))
    buf = torch.full((size + lanes,), init, dtype=vals.dtype,
                     device=vals.device)
    if reduce == "sum":
        buf.index_add_(0, idx, vals)
    else:
        buf.scatter_reduce_(0, idx, vals, reduce=reduce, include_self=True)
    return buf[:size]


def _seg_scatter(seg_id: torch.Tensor, values: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Sum ``values`` per segment into an [n]-sized per-segment array."""
    return _scatter(n, seg_id, values.to(_I32), "sum", 0)


def _permute_set(order: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``zeros.at[order].set(values)`` for a permutation ``order``."""
    out = torch.empty_like(values)
    out[order.long()] = values
    return out


def _scatter_merge(V: torch.Tensor, tgt: torch.Tensor, filter_op: str,
                   tags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fold every lane of ``V`` into ``V[tgt]`` with the filter op; lanes
    with ``tgt`` out of range (``n``) do not fold.

    ``filter_op="tagged"``: ``tags`` marks each lane's merge family (False =
    min, True = add).  A lane and its leader share an index, hence a tag, so
    the two folds hit disjoint targets and compose.
    """
    if filter_op not in ("add", "min", "max", "tagged"):
        raise ValueError(filter_op)
    if filter_op == "tagged" and tags is None:
        raise ValueError("filter_op='tagged' requires per-lane tags")
    n = V.shape[0]
    lanes = torch.nonzero(tgt < n).flatten()
    out = V.clone()
    if lanes.numel() == 0:
        return out
    dst, src = tgt[lanes].long(), V[lanes]

    def fold(op, sel):
        d, s = dst[sel], src[sel]
        if op == "add":
            out.index_add_(0, d, s)
        else:
            out.scatter_reduce_(0, _pex(d, s).expand_as(s).contiguous(), s,
                                reduce="amin" if op == "min" else "amax",
                                include_self=True)

    if filter_op == "tagged":
        lane_tag = tags[lanes]
        fold("min", ~lane_tag)
        fold("add", lane_tag)
    else:
        fold(filter_op, slice(None))
    return out


def _lane_tags(tag_table: Optional[torch.Tensor],
               I: torch.Tensor) -> Optional[torch.Tensor]:
    """Per-lane family tags recomputed from an index frame (the tag is a
    pure function of the index; out-of-range lanes clip into the table and
    their tag is never consumed)."""
    if tag_table is None:
        return None
    return tag_table[I.long().clamp(0, tag_table.shape[0] - 1)]


def _segment_fields(S: torch.Tensor):
    """Per-set segment bookkeeping over a set-major sorted stream."""
    n = S.shape[0]
    ar = _ar(n, S.device)
    new_seg = torch.cat([torch.ones(1, dtype=torch.bool, device=S.device),
                         S[1:] != S[:-1]])
    seg_id = _cumsum(new_seg) - 1
    seg_start = _cummax(torch.where(new_seg, ar, 0))
    rank = ar - seg_start                        # within-set arrival rank
    # per-segment arrays live in [n]-sized slots indexed by seg_id
    seg_len = _seg_scatter(seg_id, torch.ones(n, dtype=_I32, device=S.device),
                           n)
    seg_set = _seg_scatter(seg_id, torch.where(new_seg, S, 0), n)
    seg_startA = _seg_scatter(seg_id, torch.where(new_seg, ar, 0), n)
    return ar, new_seg, seg_id, rank, seg_len, seg_set, seg_startA


def _keys_nofilter(S, Pos, ar, new_seg, rank, *, slots: int):
    """Closed-form round boundaries: every ``slots`` arrivals flush."""
    n = S.shape[0]
    g_new = new_seg | (rank % slots == 0)
    gid = _cumsum(g_new) - 1
    g_size = _seg_scatter(gid, torch.ones(n, dtype=_I32, device=S.device), n)
    g_startA = _seg_scatter(gid, torch.where(g_new, ar, 0), n)
    g_last = (g_startA + g_size - 1).clamp(0, n - 1)
    full = g_size == slots
    g_band = torch.where(full, BAND_FLUSH, BAND_DRAIN).to(_I32)
    g_key = torch.where(full, Pos[g_last.long()],
                        _seg_scatter(gid, torch.where(g_new, S, 0), n))
    filtered = torch.zeros(n, dtype=torch.bool, device=S.device)
    gl = gid.long()
    return filtered, g_band[gl], g_key[gl]


def _keys_hash_filter(I, Pos, valid, seg_fields, psr, *, slots: int):
    """Round peeling: one vectorized pass over all sets per round.

    ``psr[i]`` is the within-set rank of the previous same-(set, index)
    element (-1 if none / padding); an element is filtered exactly when
    that rank falls inside the current round.
    """
    n = I.shape[0]
    dev = I.device
    ar, new_seg, seg_id, rank, seg_len, seg_set, seg_startA = seg_fields
    sid = seg_id.long()
    BIG = n + 1
    cur = torch.zeros(n, dtype=_I32, device=dev)
    seg_active = torch.zeros(n, dtype=torch.bool, device=dev)
    seg_active[sid] = valid
    round_of = torch.where(valid, -1, 0).to(_I32)
    filtered = torch.zeros(n, dtype=torch.bool, device=dev)
    band = torch.zeros(n, dtype=_I32, device=dev)
    key = torch.zeros(n, dtype=_I32, device=dev)
    r = 0
    while bool(seg_active.any()):
        un = round_of < 0
        dup = un & (psr >= cur[sid])
        keep = un & ~dup
        kc = _cumsum(keep)
        kcb = kc - keep.to(_I32)                 # keeps strictly before pos
        base = kcb[(seg_startA + cur).clamp(0, n - 1).long()]  # per segment
        local = kc - base[sid]                   # keep count within round
        trig_mask = keep & (local == slots)
        trigR = _scatter(n, seg_id, torch.where(trig_mask, rank, BIG),
                         "amin", BIG)
        flushed = seg_active & (trigR < BIG)
        lim = torch.where(flushed, trigR, BIG)[sid]
        take = un & seg_active[sid] & (rank <= lim)
        round_of = torch.where(take, r, round_of)
        filtered = filtered | (take & dup)
        tpos = (seg_startA + trigR).clamp(0, n - 1).long()
        bandA = torch.where(flushed, BAND_FLUSH, BAND_DRAIN).to(_I32)
        keyA = torch.where(flushed, Pos[tpos], seg_set)
        tk = take & keep
        band = torch.where(tk, bandA[sid], band)
        key = torch.where(tk, keyA[sid], key)
        cur = torch.where(flushed, trigR + 1, cur)
        seg_active = flushed & (cur < seg_len)
        r += 1
    return filtered, band, key, round_of


def _keys_single_round(I, V, Pos, S, valid, seg_fields, *, slots: int,
                       filter_op: str, tags: Optional[torch.Tensor] = None):
    """Closed form for streams whose round bound is one round (every live
    set's raw count fits in ``slots``):

    * an element is filtered exactly when any same-(set, index) predecessor
      exists (the whole segment is round 0);
    * a set flushes exactly when its raw count is ``slots`` with no
      duplicates, and the trigger is the segment's last element; every other
      set drains;
    * the payload merge is one (set, index)-run segment reduction.
    """
    n = I.shape[0]
    dev = I.device
    _, _, seg_id, rank, seg_len, seg_set, _ = seg_fields
    sid = seg_id.long()
    o2 = _lexsort((rank, I, S))
    S2, I2 = S[o2], I[o2]
    run_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         (S2[1:] != S2[:-1]) | (I2[1:] != I2[:-1])])
    run_new = run_new | ~valid[o2]      # padding lanes never join runs
    rid = (_cumsum(run_new) - 1).long()
    lead_pos = _seg_scatter(rid, torch.where(run_new, o2.to(_I32), 0), n)
    leader_of = _permute_set(o2, lead_pos[rid])
    first = _permute_set(o2, run_new)
    filtered = valid & ~first
    acc = _scatter_merge(V, torch.where(filtered, leader_of, n), filter_op,
                         tags)
    kept = _seg_scatter(seg_id, (~filtered & valid).to(_I32), n)
    flush_seg = (seg_len == slots) & (kept == slots)
    trig_pos = _scatter(n, seg_id, Pos, "amax", 0)
    band = torch.where(flush_seg, BAND_FLUSH, BAND_DRAIN).to(_I32)[sid]
    key = torch.where(flush_seg, trig_pos, seg_set)[sid]
    return filtered, band, key, acc


def _two_gen_fits(n: int, num_sets: int) -> bool:
    """Static guard of the reference: its packed ``set * n + lane`` key must
    fit int32.  Beyond it the presorted pipeline handles the stream."""
    return (num_sets + 1) * max(n, 1) <= 2**31


def _two_gen_plan(indices, secondary, live, sets, *, n_partitions: int,
                  num_sets: int, slots: int, filter_op: Optional[str],
                  round_cap: Optional[int],
                  tag_table: Optional[torch.Tensor] = None):
    """Closed-form analysis of a ragged stream under the *two-generation*
    specialization of the hash oracle, and its exactness guard.

    A set lives through at most two generations when its occupancy reaches
    ``slots`` at most once: generation 1 runs until the ``slots``-th
    insertion (the flush trigger ``T``); everything after ``T`` re-inserts
    into the emptied set and drains at end of stream.  Duplicates merge
    only against residents, so dedup is per (index run, generation).  Every
    output slot is computed: partition fronts (flushes by trigger time,
    then drains by set id), dead lanes in stream order, filtered tails in
    reverse detection order.

    Exactness guard (``ok``): no set starts a third generation or flushes
    twice (kept count under ``2 * slots`` wherever it flushed), and under a
    round cap the raw live counts stay within the cap.

    Returns ``(ok, (outpos, kept, acc))`` for :func:`_two_gen_emit`.
    """
    n = indices.shape[0]
    nP = n_partitions
    dev = indices.device
    ar = _ar(n, dev)
    # dead lanes take the sentinel set so every scatter drops them
    sets_l = torch.where(live, sets, num_sets).to(_I32)

    # ---- global first occurrences (generation-1 insertions) ---------------
    if filter_op is not None:
        Ik = torch.where(live, indices, _INT32_MAX)
        o = torch.argsort(Ik, stable=True)
        Io = Ik[o]
        run_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                             Io[1:] != Io[:-1]])
        run_new = run_new | ~live[o]    # dead lanes never join runs
        rid = (_cumsum(run_new) - 1).long()
        first = _permute_set(o, run_new) & live
    else:
        first = live                    # no merging: every live lane inserts

    # ---- set-major position order (one packed value sort) -----------------
    so = torch.sort(sets_l.to(torch.int64) * n + ar).values
    o_s = (so % n).long()               # lanes, position-ordered per set
    S_s = (so // n).to(_I32)
    seg_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         S_s[1:] != S_s[:-1]])

    def seg_rank(flags):
        # inclusive rank of flagged lanes within their set segment
        c = _cumsum(flags)
        base = _cummax(torch.where(seg_new, c - flags.to(_I32), 0))
        return c - base

    # flush trigger T = position of the slots-th insertion (or n: never)
    f_s = first[o_s]
    trig_slot = f_s & (seg_rank(f_s) == slots)
    T = _scatter(num_sets + 1, torch.where(trig_slot, S_s, num_sets),
                 o_s.to(_I32), "amin", n)
    gen2 = live & (ar > T[sets_l.long()])

    # ---- generation-aware dedup and payload merge -------------------------
    if filter_op is not None:
        g2o = gen2[o]
        c2 = _cumsum(g2o)
        base2 = _cummax(torch.where(run_new, c2 - g2o.to(_I32), 0))
        first2 = g2o & ((c2 - base2) == 1)   # run's gen-2 re-insert
        o32 = o.to(_I32)
        lead1 = _seg_scatter(rid, torch.where(run_new, o32, 0), n)
        lead2 = _seg_scatter(rid, torch.where(first2, o32, 0), n)
        kept = _permute_set(o, run_new | first2) & live
        filtered = live & ~kept
        leader_of = _permute_set(o, torch.where(g2o, lead2[rid], lead1[rid]))
        acc = _scatter_merge(secondary, torch.where(filtered, leader_of, n),
                             filter_op, _lane_tags(tag_table, indices))
    else:
        kept = live
        filtered = torch.zeros(n, dtype=torch.bool, device=dev)
        acc = secondary

    # ---- per-set layout counts and the exactness guard --------------------
    kept_s = _scatter(num_sets, sets_l, kept.to(_I32), "sum", 0)
    flush_s = T[:num_sets] < n
    ok = torch.all(torch.where(flush_s, kept_s < 2 * slots, True))
    if filter_op is not None and round_cap is not None:
        cnt_s = _scatter(num_sets, sets_l, torch.ones(n, dtype=_I32,
                                                      device=dev), "sum", 0)
        r_raw = torch.max((cnt_s + slots - 1) // slots)
        ok = ok & (r_raw <= round_cap)
    drain_s = kept_s - torch.where(flush_s, slots, 0).to(_I32)

    # ---- output positions: partition fronts / dead lanes / tails ----------
    set_ar = _ar(num_sets, dev)
    p_set = set_ar % nP
    nflush_p = _scatter(nP, p_set, torch.where(flush_s, slots, 0).to(_I32),
                        "sum", 0)
    ndrain_p = _scatter(nP, p_set, drain_s, "sum", 0)
    front_p = nflush_p + ndrain_p
    front_base = _cumsum(front_p) - front_p
    s_total = front_p.sum(dtype=_I32)

    # flushed-set rank within its partition, by trigger time: triggers are
    # distinct stream positions, so a cumsum over the position axis ranks
    # them without a sort
    rank_f = torch.zeros(num_sets, dtype=_I32, device=dev)
    t_cl = T[:num_sets].clamp(0, max(n - 1, 0)).long()
    for p in range(nP):
        fp = flush_s & (p_set == p)
        mark = _scatter(n, torch.where(fp, t_cl, n),
                        torch.ones(num_sets, dtype=_I32, device=dev), "sum", 0)
        rank_f = torch.where(fp, _cumsum(mark)[t_cl] - 1, rank_f)

    # per-set drain offset: exclusive prefix over the (partition, set) grid
    dd = torch.zeros(nP * num_sets, dtype=_I32, device=dev)
    dd[(p_set * num_sets + set_ar).long()] = drain_s
    d_ex = _cumsum(dd) - dd
    drain_off = (d_ex[(p_set * num_sets + set_ar).long()]
                 - d_ex[(_ar(nP, dev) * num_sets).long()][p_set.long()])

    # per-element insertion ranks (0-based), element-aligned
    k_s = kept[o_s]
    g2_s = gen2[o_s]
    rank1 = _permute_set(o_s, seg_rank(k_s & ~g2_s)) - 1
    rank2 = _permute_set(o_s, seg_rank(k_s & g2_s)) - 1

    sc = sets_l.clamp(0, max(num_sets - 1, 0)).long()
    p_e = p_set[sc].long()
    flush_e = flush_s[sc]
    is_flush = kept & ~gen2 & flush_e
    pos_flush = front_base[p_e] + rank_f[sc] * slots + rank1
    pos_drain = (front_base[p_e] + nflush_p[p_e] + drain_off[sc]
                 + torch.where(flush_e, rank2, rank1))

    t_p = _scatter(nP, torch.where(filtered, p_e, nP),
                   torch.ones(n, dtype=_I32, device=dev), "sum", 0)
    tail_base = n - t_p.sum(dtype=_I32) + (_cumsum(t_p) - t_p)
    rfil = torch.zeros(n, dtype=_I32, device=dev)
    for p in range(nP):
        fp = filtered & (p_e == p)
        rfil = torch.where(fp, _cumsum(fp) - 1, rfil)
    pos_filt = tail_base[p_e] + (t_p[p_e] - 1 - rfil)
    pos_dead = s_total + (ar - live.sum(dtype=_I32))

    outpos = torch.where(is_flush, pos_flush,
                         torch.where(kept, pos_drain,
                                     torch.where(filtered, pos_filt,
                                                 pos_dead)))
    return ok, (outpos, kept, acc)


def _two_gen_emit(indices, secondary, plan):
    """Place every lane at its precomputed output slot."""
    outpos, kept, acc = plan
    n = indices.shape[0]
    return (_permute_set(outpos, indices), _permute_set(outpos, acc),
            _permute_set(outpos, _ar(n, indices.device)),
            _permute_set(outpos, kept))


def _merge_payloads(I, V, S, rank, round_of, filtered, filter_op: str,
                    tags: Optional[torch.Tensor] = None):
    """Fold each filtered element into the surviving leader of its
    (set, index, round) group."""
    n = I.shape[0]
    o3 = _lexsort((rank, round_of, I, S))
    S3, I3, R3 = S[o3], I[o3], round_of[o3]
    lead_new = torch.cat([
        torch.ones(1, dtype=torch.bool, device=I.device),
        (S3[1:] != S3[:-1]) | (I3[1:] != I3[:-1]) | (R3[1:] != R3[:-1])])
    g3 = (_cumsum(lead_new) - 1).long()
    lead_pos = _seg_scatter(g3, torch.where(lead_new, o3.to(_I32), 0), n)
    leader_of = _permute_set(o3, lead_pos[g3])
    return _scatter_merge(V, torch.where(filtered, leader_of, n), filter_op,
                          tags)


def _keys_dense_merge(I, V, Pos, valid, filter_op: str,
                      tags: Optional[torch.Tensor] = None):
    """Dense fallback: one survivor per unique index, sorted by index value
    (the sort engine's reorder in the hash engine's output conventions)."""
    n = I.shape[0]
    # padding lanes sort last and never form duplicate runs
    Ik = torch.where(valid, I, _INT32_MAX)
    o2 = _lexsort((Pos, Ik))
    I2 = Ik[o2]
    run_new = torch.cat([torch.ones(1, dtype=torch.bool, device=I.device),
                         I2[1:] != I2[:-1]])
    run_new = run_new | ~valid[o2]
    rid = (_cumsum(run_new) - 1).long()
    lead_pos = _seg_scatter(rid, torch.where(run_new, o2.to(_I32), 0), n)
    leader_of = _permute_set(o2, lead_pos[rid])
    first = _permute_set(o2, run_new)
    filtered = valid & ~first
    acc = _scatter_merge(V, torch.where(filtered, leader_of, n), filter_op,
                         tags)
    band = torch.full((n,), BAND_FLUSH, dtype=_I32, device=I.device)
    return filtered, band, Ik, acc


def _reorder_presorted(I, V, Pos, S, valid, *, num_sets: int, slots: int,
                       filter_op: Optional[str],
                       round_cap: Optional[int] = None,
                       tags: Optional[torch.Tensor] = None):
    """Round/merge decomposition over one set-major sorted (padded) stream.

    ``S`` must be non-decreasing with padding lanes (``valid=False``) at the
    tail carrying ``S = num_sets``.  Returns per-lane ``(filtered, band,
    local_key, acc)`` for :func:`_assemble`.
    """
    seg_fields = _segment_fields(S)
    ar, new_seg, seg_id, rank, seg_len, seg_set, _ = seg_fields
    n = I.shape[0]

    if filter_op is None:
        filtered, band, key = _keys_nofilter(S, Pos, ar, new_seg, rank,
                                             slots=slots)
        acc = V
    else:
        def hash_path():
            # psr[i] = within-set rank of previous same-(set, index) element
            o2 = _lexsort((rank, I, S))
            o2_prev = torch.cat([o2[:1], o2[:-1]])
            S2, I2 = S[o2], I[o2]
            run_new = torch.cat([
                torch.ones(1, dtype=torch.bool, device=I.device),
                (S2[1:] != S2[:-1]) | (I2[1:] != I2[:-1])])
            psr = _permute_set(o2, torch.where(run_new, -1, rank[o2_prev]))
            psr = torch.where(valid, psr, -1)
            filtered, band, key, round_of = _keys_hash_filter(
                I, Pos, valid, seg_fields, psr, slots=slots)
            acc = _merge_payloads(I, V, S, rank, round_of, filtered,
                                  filter_op, tags)
            return filtered, band, key, acc

        def single_path():
            return _keys_single_round(I, V, Pos, S, valid, seg_fields,
                                      slots=slots, filter_op=filter_op,
                                      tags=tags)

        # each full round consumes >= slots elements of its set, so the
        # per-set ceil(len / slots) bounds the trip count a priori; a bound
        # of one makes the peeling loop a single iteration
        seg_rounds = torch.where(seg_set < num_sets,
                                 (seg_len + slots - 1) // slots, 0)
        r_ub = int(seg_rounds.max()) if n else 0
        if round_cap is not None and r_ub > round_cap:
            filtered, band, key, acc = _keys_dense_merge(I, V, Pos, valid,
                                                         filter_op, tags)
        elif r_ub <= 1:
            filtered, band, key, acc = single_path()
        else:
            filtered, band, key, acc = hash_path()
    band = torch.where(valid, band, BAND_PAD).to(_I32)
    # padding keys collapse to 0 so pads order purely by stream position
    key = torch.where(valid, key, 0).to(_I32)
    filtered = filtered & valid
    return filtered, band, key, acc


def _assemble(I, V, Pos, valid, filtered, band, key, acc):
    """Emission layout over one (padded) stream: survivors at the front by
    (band, key, stream position), filtered lanes closing the tail in
    reverse detection order."""
    L = I.shape[0]
    ar = _ar(L, I.device)
    band_eff = torch.where(filtered, _BAND_FILTERED, band)
    em = _lexsort((Pos, key, band_eff))
    front_pos = _permute_set(em, ar)
    fo = torch.argsort(torch.where(filtered, Pos, _INT32_MAX), stable=True)
    frank = _permute_set(fo, ar)
    out_position = torch.where(filtered, L - 1 - frank, front_pos)
    return (_permute_set(out_position, I),
            _permute_set(out_position,
                         torch.where(_pex(filtered, V), V, acc)),
            _permute_set(out_position, Pos),
            _permute_set(out_position, ~filtered & valid))


def _dense_merge_flat(indices, secondary, filter_op: str,
                      tags: Optional[torch.Tensor] = None):
    """Whole-stream dense fallback, direct form: survivors take their rank
    in (index, arrival) order, duplicates the tail in reverse detection
    order."""
    n = indices.shape[0]
    dev = indices.device
    o = torch.argsort(indices, stable=True)
    I2 = indices[o]
    run_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         I2[1:] != I2[:-1]])
    rid = (_cumsum(run_new) - 1).long()
    lead_pos = _seg_scatter(rid, torch.where(run_new, o.to(_I32), 0), n)
    leader_of = _permute_set(o, lead_pos[rid])
    first = _permute_set(o, run_new)
    filtered = ~first
    acc = _scatter_merge(secondary, torch.where(filtered, leader_of, n),
                         filter_op, tags)
    surv_rank = _cumsum(run_new) - 1                          # per sorted pos
    pos_of = _permute_set(o, surv_rank)
    frank = _cumsum(filtered) - 1                             # stream order
    out_position = torch.where(filtered, n - 1 - frank, pos_of)
    return (_permute_set(out_position, indices),
            _permute_set(out_position,
                         torch.where(_pex(filtered, secondary), secondary,
                                     acc)),
            _permute_set(out_position, _ar(n, dev)),
            _permute_set(out_position, ~filtered))


def hash_reorder_batched(
    indices: torch.Tensor,
    secondary: torch.Tensor,
    *,
    num_sets: int = 1024,
    slots: int = 32,
    elem_bytes: int = 4,
    block_bytes: int = 128,
    filter_op: Optional[str] = None,
    round_cap: Optional[int] = None,
    n_live: torch.Tensor | int | None = None,
    tag_table: Optional[torch.Tensor] = None,
):
    """Batch-parallel hash reorder; stream-identical to
    ``ref.hash_reorder_ref`` (``ref.hash_reorder_ref_flat`` with
    ``round_cap``).

    ``filter_op="tagged"`` merges each duplicate group under its index's
    family (``tag_table``: bool, True = add).  ``n_live`` (a 0-d tensor or
    int, never a shape) makes the stream ragged: the result is the oracle
    on the live prefix, laid out in the padded buffer -- survivors at the
    front, dead lanes in the middle in stream order (``active=False``,
    original values), the filtered tail closing the buffer.

    Returns ``(out_idx, out_sec, out_pos, out_act)``.
    """
    indices = indices.to(_I32)
    if (filter_op == "tagged") != (tag_table is not None):
        raise ValueError("filter_op='tagged' and tag_table go together")
    n = indices.shape[0]
    dev = indices.device
    epb = block_bytes // elem_bytes
    if n == 0:
        return (indices, secondary, torch.zeros(0, dtype=_I32, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))

    sets = hash_set(torch.div(indices, epb, rounding_mode="floor"), num_sets)
    if n_live is None:
        live = None
    else:
        m_live = torch.as_tensor(n_live, dtype=_I32, device=dev).clamp(0, n)
        live = _ar(n, dev) < m_live
        # sentinel set: dead lanes sort to the tail as inert padding
        sets = torch.where(live, sets, num_sets).to(_I32)

    def hash_fn():
        order = torch.argsort(sets, stable=True)  # set-major, stream order
        S = sets[order]
        I = indices[order]
        V = secondary[order]
        Pos = order.to(_I32)
        valid = (torch.ones(n, dtype=torch.bool, device=dev) if live is None
                 else live[order])
        filtered, band, key, acc = _reorder_presorted(
            I, V, Pos, S, valid, num_sets=num_sets, slots=slots,
            filter_op=filter_op,
            # padded streams decide the cap below, before the set sort;
            # ragged ones decide inside the sorted layout
            round_cap=(round_cap if live is not None else None),
            tags=_lane_tags(tag_table, I))
        return _assemble(I, V, Pos, valid, filtered, band, key, acc)

    if live is not None and _two_gen_fits(n, num_sets):
        ok, plan = _two_gen_plan(
            indices, secondary, live, sets, n_partitions=1,
            num_sets=num_sets, slots=slots, filter_op=filter_op,
            round_cap=round_cap, tag_table=tag_table)
        if bool(ok):
            return _two_gen_emit(indices, secondary, plan)
        return hash_fn()
    if filter_op is None or round_cap is None or live is not None:
        return hash_fn()
    # round-cap hybrid: the trip-count bound is one bincount away, so decide
    # before paying the set sort
    counts = _scatter(num_sets, sets, torch.ones(n, dtype=_I32, device=dev),
                      "sum", 0)
    r_ub = int(torch.max((counts + slots - 1) // slots))
    if r_ub > round_cap:
        return _dense_merge_flat(indices, secondary, filter_op,
                                 _lane_tags(tag_table, indices))
    return hash_fn()

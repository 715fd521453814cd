"""The oracle of kernel B3: numpy copies of the reference's IRU hash oracles.

In this kernel directory ``ref.py`` keeps the reference's meaning: the
numpy oracle (``repro.kernels.iru_reorder.ref``), copied function for
function and bit-identical to it (``tests/test_torch_hash.py`` checks).  The
plain PyTorch version of B3 -- what a card run holds the kernel against --
is ``batched.py``.  ``core.iru`` runs ``mode="hash_ref"`` on these.

Semantics (paper §3.2-3.3):

* key      = index // (block_bytes // elem_bytes)            (memory block id)
* set      = mix(key) % num_sets   (multiplicative hash)
* insert   : conflict-tolerant -- a set accepts an element whatever the
             block tags of its residents.
* merge    : with a filter op, an incoming element whose *index* equals a
             resident's folds into it (add/min/max on the payload) and takes
             no slot -- the element is filtered.
* flush    : when a set reaches ``slots`` residents it is emitted in
             insertion order and cleared.
* drain    : at end of stream, surviving sets are emitted in set order.
* layout   : survivors at the front in emission order; filtered elements
             fill the tail in REVERSE detection order with ``active=False``.

``hash_reorder_ref`` is the element-sequential loop, ``hash_reorder_ref_vec``
its batch-parallel twin (same outputs, fp add order included);
``hash_reorder_ref_flat`` adds the ``round_cap`` dense fallback
(``dense_merge_ref``, decided by ``max_round_bound``); ``ragged_oracle``
composes any of them with the ``n_live`` layout.  ``hash_reorder_ref_banked``
is the partitioned unit (paper §3.2: sets striped as ``set % n_partitions``,
each partition's sub-stream reordered on its own with its own round-cap
decision, partition-major emission, and the ``partition_capacity`` bypass
through the flat oracle).  ``moe_dispatch_ref`` is the MoE dispatch plan's
oracle (identity-keyed occupancy: arrival ranks, capacity survival, load and
drop counts).
"""
from __future__ import annotations

import numpy as np

_MIX = np.uint64(2654435761)


def hash_set(key: np.ndarray, num_sets: int) -> np.ndarray:
    h = (key.astype(np.uint64) * _MIX) & np.uint64(0xFFFFFFFF)
    h = h ^ (h >> np.uint64(16))
    return (h % np.uint64(num_sets)).astype(np.int64)


def hash_reorder_ref(
    indices: np.ndarray,
    secondary: np.ndarray,
    *,
    num_sets: int = 1024,
    slots: int = 32,
    elem_bytes: int = 4,
    block_bytes: int = 128,
    filter_op: str | None = None,
):
    indices = np.asarray(indices, np.int32)
    secondary = np.asarray(secondary)
    n = indices.shape[0]
    epb = block_bytes // elem_bytes
    payload = secondary.shape[1:]

    tbl_idx = np.zeros((num_sets, slots), np.int32)
    tbl_sec = np.zeros((num_sets, slots) + payload, secondary.dtype)
    tbl_pos = np.zeros((num_sets, slots), np.int32)
    cnt = np.zeros(num_sets, np.int32)

    out_idx = np.zeros(n, np.int32)
    out_sec = np.zeros((n,) + payload, secondary.dtype)
    out_pos = np.zeros(n, np.int32)
    out_act = np.zeros(n, bool)
    head = 0         # survivors cursor (front)
    tail = 0         # filtered cursor (back, reverse detection order)

    def flush(s: int):
        nonlocal head
        c = int(cnt[s])
        out_idx[head : head + c] = tbl_idx[s, :c]
        out_sec[head : head + c] = tbl_sec[s, :c]
        out_pos[head : head + c] = tbl_pos[s, :c]
        out_act[head : head + c] = True
        head += c
        cnt[s] = 0

    for i in range(n):
        idx = indices[i]
        key = idx // epb
        s = int(hash_set(np.asarray(key), num_sets))
        c = int(cnt[s])
        if filter_op is not None:
            match = np.nonzero(tbl_idx[s, :c] == idx)[0]
            if match.size:
                j = int(match[0])
                if filter_op == "add":
                    tbl_sec[s, j] = tbl_sec[s, j] + secondary[i]
                elif filter_op == "min":
                    tbl_sec[s, j] = np.minimum(tbl_sec[s, j], secondary[i])
                elif filter_op == "max":
                    tbl_sec[s, j] = np.maximum(tbl_sec[s, j], secondary[i])
                else:
                    raise ValueError(filter_op)
                tail += 1
                out_idx[n - tail] = idx
                out_sec[n - tail] = secondary[i]
                out_pos[n - tail] = i
                out_act[n - tail] = False
                continue
        tbl_idx[s, c] = idx
        tbl_sec[s, c] = secondary[i]
        tbl_pos[s, c] = i
        cnt[s] = c + 1
        if cnt[s] == slots:
            flush(s)

    for s in range(num_sets):
        if cnt[s]:
            flush(s)
    assert head == n - tail
    return out_idx, out_sec, out_pos, out_act


def hash_reorder_ref_vec(
    indices: np.ndarray,
    secondary: np.ndarray,
    *,
    num_sets: int = 1024,
    slots: int = 32,
    elem_bytes: int = 4,
    block_bytes: int = 128,
    filter_op: str | None = None,
):
    """Batch-parallel twin of :func:`hash_reorder_ref` (same outputs).

    Decomposition: elements are bucketed per hash set (stable sort keeps
    stream order inside each set).  Within a set, life is a sequence of
    *rounds* — the residency periods between flushes.  A round ends when its
    ``slots``-th kept element arrives (flush, emitted at the stream position
    of that trigger element) or at end-of-stream (drain, emitted in set
    order after every flush).  Without a filter op round boundaries are the
    closed form ``rank // slots``; with one, an element is filtered exactly
    when a same-index element already landed in the current round, so rounds
    are peeled iteratively — one vectorized pass over all sets per round
    generation, never a per-element loop.
    """
    indices = np.asarray(indices, np.int32)
    secondary = np.asarray(secondary)
    n = indices.shape[0]
    epb = block_bytes // elem_bytes
    payload = secondary.shape[1:]

    out_idx = np.zeros(n, np.int32)
    out_sec = np.zeros((n,) + payload, secondary.dtype)
    out_pos = np.zeros(n, np.int32)
    out_act = np.zeros(n, bool)
    if n == 0:
        return out_idx, out_sec, out_pos, out_act

    sets = hash_set(indices // np.int32(epb), num_sets)
    order = np.argsort(sets, kind="stable")     # set-major, stream order within
    S = sets[order]
    new_seg = np.empty(n, bool)
    new_seg[0] = True
    new_seg[1:] = S[1:] != S[:-1]
    seg_id = np.cumsum(new_seg) - 1             # dense per-set segment id
    starts = np.flatnonzero(new_seg)            # segment -> first sorted pos
    seg_len = np.diff(np.append(starts, n))
    rank = np.arange(n) - starts[seg_id]        # within-set arrival rank

    if filter_op is None:
        # Closed form: round = rank // slots; no element is ever filtered.
        g_new = new_seg | (rank % slots == 0)
        gid = np.cumsum(g_new) - 1
        g_start = np.flatnonzero(g_new)
        g_size = np.diff(np.append(g_start, n))
        full = g_size == slots
        trigger = order[g_start + g_size - 1]   # stream pos of round's last elem
        # emission: flushes by trigger stream position, then drains by set id
        key_a = np.where(full, 0, 1)
        key_b = np.where(full, trigger, S[g_start])
        g_emit = np.lexsort((key_b, key_a))
        g_off = np.empty(len(g_start), np.int64)
        g_off[g_emit] = np.concatenate(([0], np.cumsum(g_size[g_emit])[:-1]))
        out_position = g_off[gid] + (np.arange(n) - g_start[gid])
        out_idx[out_position] = indices[order]
        out_sec[out_position] = secondary[order]
        out_pos[out_position] = order.astype(np.int32)
        out_act[out_position] = True
        return out_idx, out_sec, out_pos, out_act

    # --- filter path: peel rounds iteratively (vectorized across all sets) ---
    I = indices[order]
    # prev_same[i] = within-set rank of the previous same-(set, index) element
    o2 = np.lexsort((rank, I, S))
    S2, I2 = S[o2], I[o2]
    run_new = np.empty(n, bool)
    run_new[0] = True
    run_new[1:] = (S2[1:] != S2[:-1]) | (I2[1:] != I2[:-1])
    prev_same = np.full(n, -1, np.int64)        # indexed by sorted pos
    cont = np.flatnonzero(~run_new)
    prev_same[o2[cont]] = rank[o2[cont - 1]]

    nseg = len(starts)
    BIG = n + 1
    cur = np.zeros(nseg, np.int64)              # per-set current round start
    seg_active = np.ones(nseg, bool)
    round_of = np.full(n, -1, np.int64)
    filtered = np.zeros(n, bool)                # per sorted pos
    grp_a = np.zeros(n, np.int64)               # emission keys (kept elems)
    grp_b = np.zeros(n, np.int64)

    r = 0
    while seg_active.any():
        un = round_of < 0
        dup = un & (prev_same >= cur[seg_id])
        keep = un & ~dup
        kc = np.cumsum(keep)
        # keeps strictly before each set's current round start
        base_pos = starts + cur                  # first unassigned pos per set
        base = np.where(base_pos < n, kc[np.minimum(base_pos, n - 1)]
                        - keep[np.minimum(base_pos, n - 1)], kc[-1])
        local = kc - base[seg_id]                # keep count within round
        trig_mask = keep & (local == slots)
        trig_rank = np.full(nseg, BIG, np.int64)
        np.minimum.at(trig_rank, seg_id[trig_mask], rank[trig_mask])
        flushed = seg_active & (trig_rank < BIG)
        lim = np.where(flushed, trig_rank, BIG)
        take = un & seg_active[seg_id] & (rank <= lim[seg_id])
        round_of[take] = r
        filtered[take] = dup[take]
        tpos = starts + np.minimum(trig_rank, n - 1 - starts)
        key_a_seg = np.where(flushed, 0, 1)
        key_b_seg = np.where(flushed, order[tpos], S[starts])
        grp_a[take] = key_a_seg[seg_id[take]]
        grp_b[take] = key_b_seg[seg_id[take]]
        cur = np.where(flushed, trig_rank + 1, cur)
        seg_active = flushed & (cur < seg_len)
        r += 1

    kept = np.flatnonzero(~filtered)
    emit = kept[np.lexsort((kept, grp_b[kept], grp_a[kept]))]
    m = len(emit)

    # merge payloads: each filtered element folds into the kept element of its
    # (set, index, round) group, applied in stream order (bit-identical fp).
    o3 = np.lexsort((rank, round_of, I, S))
    S3, I3, R3 = S[o3], I[o3], round_of[o3]
    lead_new = np.empty(n, bool)
    lead_new[0] = True
    lead_new[1:] = (S3[1:] != S3[:-1]) | (I3[1:] != I3[:-1]) | (R3[1:] != R3[:-1])
    leaders = o3[np.flatnonzero(lead_new)]
    leader_of = np.empty(n, np.int64)           # sorted pos -> leader sorted pos
    leader_of[o3] = leaders[np.cumsum(lead_new) - 1]

    acc = secondary[order].copy()
    f_sorted = np.flatnonzero(filtered)
    f_stream = f_sorted[np.argsort(order[f_sorted])]   # detection (stream) order
    tgt = leader_of[f_stream]
    vals = secondary[order[f_stream]]
    if filter_op == "add":
        np.add.at(acc, tgt, vals)
    elif filter_op == "min":
        np.minimum.at(acc, tgt, vals)
    elif filter_op == "max":
        np.maximum.at(acc, tgt, vals)
    else:
        raise ValueError(filter_op)

    out_idx[:m] = I[emit]
    out_sec[:m] = acc[emit]
    out_pos[:m] = order[emit]
    out_act[:m] = True
    t = len(f_stream)
    if t:
        tail_slots = n - 1 - np.arange(t)
        orig = order[f_stream]
        out_idx[tail_slots] = indices[orig]
        out_sec[tail_slots] = secondary[orig]
        out_pos[tail_slots] = orig.astype(np.int32)
    assert m == n - t
    return out_idx, out_sec, out_pos, out_act


# ---------------------------------------------------------------------------
# Multi-partition banking + round-cap hybrid oracles
# ---------------------------------------------------------------------------


def partition_capacity(n: int, n_partitions: int) -> int:
    """Static per-partition bank capacity for an n-element stream.

    A balanced hash sends ~``n / P`` elements to each partition; the bank
    buffer carries 25% headroom (at least 64 lanes) so benign skew never
    trips the bypass.  Shared by the numpy oracle and the JAX banked engine
    so the capacity-overflow decision is part of the semantics, not a
    per-engine heuristic.
    """
    if n_partitions <= 1:
        return n
    per = -(-n // n_partitions)
    return min(n, per + max(64, per // 4))


def max_round_bound(
    indices: np.ndarray, *, num_sets: int, slots: int,
    elem_bytes: int = 4, block_bytes: int = 128,
) -> int:
    """Upper bound on the occupancy-round count of a stream.

    Every full round consumes at least ``slots`` elements of its set
    (fillers plus same-round duplicates), so ``ceil(n_set / slots)`` bounds
    the rounds of each set and the max over sets bounds the filter-path
    while-loop trip count.  Cheap (one bincount), computable before any
    round is peeled — this is the quantity the round cap compares against.
    """
    indices = np.asarray(indices, np.int32)
    if indices.shape[0] == 0:
        return 0
    epb = block_bytes // elem_bytes
    sets = hash_set(indices // np.int32(epb), num_sets)
    counts = np.bincount(sets, minlength=num_sets)
    return int(-(-counts.max() // slots))


def dense_merge_ref(
    indices: np.ndarray,
    secondary: np.ndarray,
    *,
    filter_op: str | None = None,
):
    """Round-cap fallback semantics: sort-merge in hash-layout conventions.

    Survivors occupy the front sorted by (index value, arrival); with a
    filter op every later duplicate folds into the first occurrence (merge
    applied in stream order) and parks at the tail in reverse detection
    order.  Without a filter op nothing is filtered — the output is simply
    the stable index sort.
    """
    indices = np.asarray(indices, np.int32)
    secondary = np.asarray(secondary)
    n = indices.shape[0]
    payload = secondary.shape[1:]
    out_idx = np.zeros(n, np.int32)
    out_sec = np.zeros((n,) + payload, secondary.dtype)
    out_pos = np.zeros(n, np.int32)
    out_act = np.zeros(n, bool)
    if n == 0:
        return out_idx, out_sec, out_pos, out_act

    o = np.argsort(indices, kind="stable")      # (index value, arrival)
    if filter_op is None:
        out_idx[:] = indices[o]
        out_sec[:] = secondary[o]
        out_pos[:] = o.astype(np.int32)
        out_act[:] = True
        return out_idx, out_sec, out_pos, out_act

    I2 = indices[o]
    run_new = np.empty(n, bool)
    run_new[0] = True
    run_new[1:] = I2[1:] != I2[:-1]
    rid = np.cumsum(run_new) - 1
    leaders = o[np.flatnonzero(run_new)]        # stream pos of each survivor
    leader_of = leaders[rid]                    # sorted pos -> leader stream pos
    first = np.zeros(n, bool)
    first[o] = run_new
    dup_stream = np.flatnonzero(~first)         # detection (stream) order

    acc = secondary.copy()
    tgt = leader_of[np.argsort(o)][dup_stream]  # leader stream pos per dup
    vals = secondary[dup_stream]
    if filter_op == "add":
        np.add.at(acc, tgt, vals)
    elif filter_op == "min":
        np.minimum.at(acc, tgt, vals)
    elif filter_op == "max":
        np.maximum.at(acc, tgt, vals)
    else:
        raise ValueError(filter_op)

    surv = leaders
    m = surv.shape[0]
    out_idx[:m] = indices[surv]
    out_sec[:m] = acc[surv]
    out_pos[:m] = surv.astype(np.int32)
    out_act[:m] = True
    t = dup_stream.shape[0]
    if t:
        tail_slots = n - 1 - np.arange(t)
        out_idx[tail_slots] = indices[dup_stream]
        out_sec[tail_slots] = secondary[dup_stream]
        out_pos[tail_slots] = dup_stream.astype(np.int32)
    assert m == n - t
    return out_idx, out_sec, out_pos, out_act


def hash_reorder_ref_flat(
    indices: np.ndarray,
    secondary: np.ndarray,
    *,
    num_sets: int = 1024,
    slots: int = 32,
    elem_bytes: int = 4,
    block_bytes: int = 128,
    filter_op: str | None = None,
    round_cap: int | None = None,
):
    """Single-partition oracle with the round-cap hybrid rule applied."""
    if (filter_op is not None and round_cap is not None
            and max_round_bound(indices, num_sets=num_sets, slots=slots,
                                elem_bytes=elem_bytes,
                                block_bytes=block_bytes) > round_cap):
        return dense_merge_ref(indices, secondary, filter_op=filter_op)
    return hash_reorder_ref_vec(
        indices, secondary, num_sets=num_sets, slots=slots,
        elem_bytes=elem_bytes, block_bytes=block_bytes, filter_op=filter_op)


def ragged_oracle(
    oracle,
    indices: np.ndarray,
    secondary: np.ndarray,
    n_live: int,
    **kwargs,
):
    """Compose any reorder oracle with the ragged-prefix output contract.

    This IS the semantics the JAX engines implement for ``n_live``: run
    ``oracle`` on the live prefix, then lay the result out in the original
    padded buffer — survivors at the front, the dead lanes in the middle in
    stream order (``active=False``, original index/payload/position), and
    the filtered tail closing the buffer.  The engine parity tests compare
    against this composition; keeping it next to the oracles makes the
    ragged contract part of the semantics rather than a per-test idiom.
    """
    indices = np.asarray(indices, np.int32)
    secondary = np.asarray(secondary)
    n = indices.shape[0]
    m = int(np.clip(n_live, 0, n))
    oi, osec, opos, oact = oracle(indices[:m], secondary[:m], **kwargs)
    t = int((~oact).sum())
    s = m - t
    payload = secondary.shape[1:]
    out_idx = np.zeros(n, np.int32)
    out_sec = np.zeros((n,) + payload, secondary.dtype)
    out_pos = np.zeros(n, np.int32)
    out_act = np.zeros(n, bool)
    out_idx[:s], out_sec[:s], out_pos[:s] = oi[:s], osec[:s], opos[:s]
    out_act[:s] = True
    out_idx[s : n - t] = indices[m:]
    out_sec[s : n - t] = secondary[m:]
    out_pos[s : n - t] = np.arange(m, n, dtype=np.int32)
    if t:
        out_idx[n - t :] = oi[m - t :]
        out_sec[n - t :] = osec[m - t :]
        out_pos[n - t :] = opos[m - t :]
    return out_idx, out_sec, out_pos, out_act


def hash_reorder_ref_banked(
    indices: np.ndarray,
    secondary: np.ndarray,
    *,
    num_sets: int = 1024,
    slots: int = 32,
    elem_bytes: int = 4,
    block_bytes: int = 128,
    filter_op: str | None = None,
    n_partitions: int = 4,
    round_cap: int | None = None,
):
    """Partitioned oracle: ``set % n_partitions`` sharding, partition-major
    emission, per-partition round-cap fallback, capacity bypass."""
    indices = np.asarray(indices, np.int32)
    secondary = np.asarray(secondary)
    n = indices.shape[0]

    def flat(idx, sec):
        return hash_reorder_ref_flat(
            idx, sec, num_sets=num_sets, slots=slots, elem_bytes=elem_bytes,
            block_bytes=block_bytes, filter_op=filter_op, round_cap=round_cap)

    if n_partitions <= 1 or n == 0:
        return flat(indices, secondary)

    epb = block_bytes // elem_bytes
    part = hash_set(indices // np.int32(epb), num_sets) % n_partitions
    counts = np.bincount(part, minlength=n_partitions)
    if counts.max() > partition_capacity(n, n_partitions):
        return flat(indices, secondary)          # bank capacity bypass

    fronts, tails = [], []
    for p in range(n_partitions):
        sel = np.flatnonzero(part == p).astype(np.int32)
        oi, osec, opos, oact = flat(indices[sel], secondary[sel])
        opos = sel[opos]                          # local -> global positions
        m = int(oact.sum())
        fronts.append((oi[:m], osec[:m], opos[:m], oact[:m]))
        tails.append((oi[m:], osec[m:], opos[m:], oact[m:]))
    parts = fronts + tails
    return tuple(np.concatenate([q[i] for q in parts], axis=0)
                 for i in range(4))


def moe_dispatch_ref(
    experts,
    cap: int,
    n_experts: int,
    n_live: int | None = None,
):
    """Numpy oracle for the MoE dispatch plan (identity-keyed hash occupancy).

    ``experts``: int (T, k) routed expert ids, flattened token-major into the
    (token, expert) lane stream.  ``cap`` is the per-expert capacity (the
    hash engine's ``slots`` bound), ``n_live`` the live *token* prefix.
    Returns ``(rank, keep, counts, dropped)``: per-lane arrival rank within
    the lane's expert, the capacity survival mask (live and rank < cap),
    the per-expert live arrival counts and overflow drop counts -- the exact
    integers the planner (``repro_torch.moe.dispatch.plan_dispatch``) must
    emit.
    """
    experts = np.asarray(experts, np.int64)
    T, k = experts.shape
    flat = experts.reshape(-1)
    lanes = flat.shape[0]
    live_lanes = lanes if n_live is None else max(0, min(int(n_live), T)) * k

    rank = np.zeros(lanes, np.int32)
    counts = np.zeros(n_experts, np.int64)
    for i in range(live_lanes):                    # arrival order, one pass
        e = int(flat[i])
        rank[i] = counts[e]
        counts[e] += 1
    keep = np.zeros(lanes, bool)
    keep[:live_lanes] = rank[:live_lanes] < cap
    dropped = counts - np.minimum(counts, cap)
    return rank, keep, counts.astype(np.int32), dropped.astype(np.int32)

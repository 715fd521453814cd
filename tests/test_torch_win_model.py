"""The windowed body of kernel B3, modelled in numpy and held against the
banked IRU hash oracles of both packages.

B3's windowed body (``win_reorder`` in ``kernels/iru_reorder/iru_reorder.cu``)
reorders each window of ``w`` lanes in one CTA, in shared memory:

* **load + histogram**: each lane's set, counted in its ranking stretch
  (``rankers`` stretches of whole 32-lane steps); the per-set totals decide
  the bank bypass (a partition past ``partition_capacity(m, P)`` lays the
  window out as one partition) and the round-cap fallback (a set past
  ``round_cap * slots`` arrivals sends its partition to the dense
  fallback);
* **bin**: a stable counting sort by set key (partition-major): each set's
  first slot, each stretch's first slot in each set, then a warp a stretch
  places its lanes in stream order; a capped partition's lanes are then
  sorted by (index, lane); the payloads load after it;
* **walk**: the hot sets (past ``slots`` arrivals) by the walk of the
  whole-stream body (``_walk_set`` of ``tests/test_torch_hash_walk.py``
  models it); the small ones a chunk of 32 set keys a warp, several sets a
  32-lane step (``_walk_small_step``): a set of at most ``slots`` arrivals
  fills at most once, at its last arrival, so an arrival is filtered iff an
  earlier one of the step has its index, and the first folds the rest in
  lane order; kept entries are put over the set's arrivals, triggers and
  filtered lanes marked in the lane's aux word (set key << 2 | mark);
* **fallback**: in a capped partition each run of equal indices folds into
  its first lane, in lane (stream) order;
* **emit**: the drain offsets over the set keys; one mark scan over the
  lanes in stream order for four partitions at a time, with packed 16-bit
  counters (a trigger's partition from its index, a filtered lane's from
  its aux word), which writes each trigger's flush rank into its aux word
  and each filtered lane to its tail slot; then one pass over the binned
  slots places the kept entries; the dead lanes between.

Tagged (``op`` a bool tag table, True = add), every fold of a survivor
(small set, hot set, fallback) is its index's family's, read when it
folds.

``model_window`` follows those steps, and ``model_stream`` offsets each
window's positions by its start.  It is held exactly (payloads too: both
fold in stream order) against ``ragged_oracle(hash_reorder_ref_banked)`` of
the port's ``repro_torch.kernels.iru_reorder.ref`` and the reference's
``repro.kernels.iru_reorder.ref``, window by window, on hot-set (kron),
round-cap-trip and bypass-trip windows and on the edges of the steps.  The
card tests run the kernel itself (``tests/test_torch_kernels.py``, marked
``gpu``).
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.kernels.iru_reorder import ref as jref
from repro_torch.graphs.generators import kron_edges
from repro_torch.kernels.iru_reorder import ref as tref
from test_torch_hash_walk import _fold, _walk_set

EPB = 32
WARP = 32
KEPT, TRIGGER, FILTERED = 0, 1, 2
WALK_SCRATCH = 8 * 5 * WARP * 4  # bytes of walk_set's copies, 8 warps


def rankers(num_sets, w):
    """The kernel's ranking stretches (at most 16): as many sets of 16-bit
    counters as the payload region of a ``w``-lane window holds, or the
    walk's region beside the per-set totals, whichever holds more."""
    per_set = -(-2 * num_sets // 16) * 16
    in_val = 4 * w // (2 * num_sets)
    in_r = (3 * per_set + WALK_SCRATCH) // (2 * num_sets)
    return min(16, max(in_val, in_r))


def _walk_small_step(idx, val, pos, set_of, slots, op):
    """One warp step over the arrivals of several small sets (lane order =
    stream order within each set): an arrival is kept iff no earlier lane
    has its index (``__match_any_sync``), and folds the later ones in lane
    order.  Returns, per set in lane order, what ``_walk_set`` returns."""
    first = {}
    acc = list(val)
    kept = [False] * len(idx)
    filtered = {s: [] for s in set_of}
    for lane, (i, s) in enumerate(zip(idx, set_of)):
        if op is None or i not in first:
            first[i] = lane
            kept[lane] = True
            continue
        assert set_of[first[i]] == s  # an index has one set
        acc[first[i]] = _fold(op, acc[first[i]], val[lane], i)
        filtered[s].append(pos[lane])
    out = {}
    for s in dict.fromkeys(set_of):
        res = [[idx[t], acc[t], pos[t]] for t in range(len(idx))
               if set_of[t] == s and kept[t]]
        if len(res) == slots:  # full at its last arrival
            out[s] = ([(res[-1][2], res)], [], filtered[s])
        else:
            out[s] = ([], res, filtered[s])
    return out


def _walk_small_set(idx, val, pos, slots, op):
    """The small-set walk of one set of at most ``slots`` arrivals."""
    return _walk_small_step(idx, val, pos, [0] * len(idx), slots, op)[0]


def _small_steps(keys, lens, slots, small):
    """The packing of a chunk's small sets into 32-lane steps: each step
    takes the pending sets, in key order, while their arrivals fit."""
    pending = [k for k in keys if small(k)]
    while pending:
        take, c = [], 0
        for k in pending:
            if c + lens[k] > WARP:
                break
            take.append(k)
            c += lens[k]
        pending = pending[len(take):]
        yield take


def mark_scan_prefix(contrib, m, threads=512):
    """The kernel's mark scan layout: warp w takes ``rounds`` runs of 256
    lanes from lane 256 * rounds * w, a thread 8 consecutive lanes a run.
    Returns each lane's exclusive prefix as the kernel composes it (the
    warp's prefix, the warp's earlier runs, the thread's prefix within
    the run, then the thread's own earlier lanes)."""
    warps = threads // WARP
    rounds = -(-m // (threads * 8))
    padded = np.zeros(warps * rounds * 256, np.int64)
    padded[:m] = contrib
    runs = padded.reshape(warps, rounds, WARP, 8)
    thread = runs.sum(3)                              # [warp, run, lane]
    incl = np.cumsum(thread, axis=2)
    warp_tot = incl[:, :, -1].sum(1)
    before = (np.cumsum(warp_tot) - warp_tot)[:, None, None] \
        + (np.cumsum(incl[:, :, -1], 1) - incl[:, :, -1])[:, :, None] \
        + incl - thread
    lane_pre = before[..., None] + np.cumsum(runs, 3) - runs
    return lane_pre.reshape(-1)[:m]


def model_window(idx, val, m, *, w, num_sets, slots, parts, op, round_cap,
                 stats):
    """One window of a ``w``-lane stream (the last one may be shorter), its
    first ``m`` lanes live, as the windowed body lays it out (positions
    window-local)."""
    span = idx.size
    out = [idx.copy(), val.copy(), np.arange(span, dtype=np.int32),
           np.zeros(span, bool)]
    if m == 0:  # a dead window is a copy
        return out
    x = idx[:m]
    s_val = list(val[:m])
    S = num_sets
    sets = tref.hash_set(x // np.int32(EPB), S)
    # load + histogram: each lane counts in its ranking stretch
    G = rankers(S, w)
    per = -(-(-(-m // G)) // WARP) * WARP
    counts = np.zeros((G, S), np.int64)
    for g in range(G):
        np.add.at(counts[g], sets[g * per:min(m, (g + 1) * per)], 1)
    cnt = counts.sum(0)
    layout = parts
    if parts > 1:
        pc = np.bincount(sets % parts, minlength=parts)
        if pc.max() > tref.partition_capacity(m, parts):
            layout = 1
            stats["bypass"] += 1
    q = S // layout
    dense = np.zeros(layout, bool)
    if op is not None and round_cap is not None:
        for s in np.flatnonzero(cnt > round_cap * slots):
            dense[s % layout] = True
    stats["dense"] += int(dense.any())
    # bin: a stable counting sort by set key
    key_of_set = (np.arange(S) % layout) * q + np.arange(S) // layout
    set_of_key = np.argsort(key_of_set)
    start = np.concatenate(([0], np.cumsum(cnt[set_of_key])))
    slot = np.zeros((G, S), np.int64)  # each warp's next slot in each set
    for k, s in enumerate(set_of_key):
        slot[:, s] = start[k] + np.cumsum(counts[:, s]) - counts[:, s]
    order = np.zeros(m, np.int64)
    for g in range(G):  # in stream order, as __match_any_sync ranks a step
        for j in range(g * per, min(m, (g + 1) * per)):
            order[slot[g, sets[j]]] = j
            slot[g, sets[j]] += 1
    keys = key_of_set[sets]
    assert np.array_equal(order, np.argsort(keys, kind="stable"))
    aux = keys << 2
    part = keys // q
    for p in np.flatnonzero(dense):  # a capped partition by (index, lane)
        seg = order[start[p * q]:start[(p + 1) * q]]
        order[start[p * q]:start[(p + 1) * q]] = seg[np.lexsort((seg, x[seg]))]
    lens = np.diff(start)
    # walk: the hot sets by the warp walk, the small ones packed in steps
    nflush = np.zeros(S, np.int64)
    ndrain = np.zeros(S, np.int64)

    def settle(k, flushes, drain, filtered):
        kept = [e for _, res in flushes for e in res] + drain
        for i, e in enumerate(kept):  # put over the set's arrivals
            order[start[k] + i] = e[2]
            s_val[e[2]] = e[1]
        for _, res in flushes:
            aux[res[-1][2]] = k << 2 | TRIGGER
        aux[filtered] = k << 2 | FILTERED
        nflush[k], ndrain[k] = len(flushes), len(drain)

    for k in np.flatnonzero((lens > slots) & ~dense[np.arange(S) // q]):
        arr = order[start[k]:start[k + 1]].copy()
        settle(k, *_walk_set(x[arr], [s_val[t] for t in arr], arr, slots,
                             op, stats))
    small = lambda k: 0 < lens[k] <= slots and not dense[k // q]
    for k0 in range(0, S, WARP):
        for take in _small_steps(range(k0, min(k0 + WARP, S)), lens, slots,
                                 small):
            stats["small_sets"] += len(take)
            stats["packed_steps"] += len(take) > 1
            arr = np.concatenate([order[start[k]:start[k + 1]] for k in take])
            set_of = [k for k in take for _ in range(lens[k])]
            res = _walk_small_step(x[arr], [s_val[t] for t in arr], arr,
                                   set_of, slots, op)
            for k in take:
                stats["small_flushes"] += len(res[k][0])
                settle(k, *res[k])
    # fallback: a capped partition's runs fold into their first lanes
    heads = np.zeros(layout, np.int64)
    head_lanes = {}
    for p in np.flatnonzero(dense):
        lo, hi = start[p * q], start[(p + 1) * q]
        head_lanes[p] = []
        for r in range(lo, hi):
            ln = order[r]
            if r > lo and x[order[r - 1]] == x[ln]:
                continue
            heads[p] += 1
            head_lanes[p].append(ln)
            r2 = r + 1
            while r2 < hi and x[order[r2]] == x[ln]:
                aux[order[r2]] |= FILTERED
                s_val[ln] = _fold(op, s_val[ln], s_val[order[r2]], x[ln])
                r2 += 1
    # scans: drain offsets by set key, the partitions' fronts and tails
    live_dense = dense[np.arange(S) // q]
    dr = np.where(live_dense, 0, ndrain)
    fl = np.where(live_dense, 0, nflush)
    drain_ex = np.concatenate(([0], np.cumsum(dr)))
    flush_ex = np.concatenate(([0], np.cumsum(fl)))
    pd, pf = drain_ex[::q], flush_ex[::q]
    drain_off = drain_ex[:-1] - pd[np.arange(S) // q]
    lanes_of = (np.array([m]) if layout == 1
                else np.bincount(part, minlength=layout))
    kept = np.where(dense, heads, np.diff(pf) * slots + np.diff(pd))
    survivors = int(kept.sum())
    pfront = np.concatenate(([0], np.cumsum(kept)[:-1]))
    pfilt = lanes_of - kept
    ptail = np.concatenate(([0], np.cumsum(pfilt)[:-1]))  # within the tail
    o_idx, o_val, o_pos, o_act = out
    written = {}

    def put(o, lane, active):
        got = (x[lane], s_val[lane], lane, active)
        assert written.setdefault(o, got) == got  # a rewrite writes the same
        o_idx[o], o_val[o], o_pos[o], o_act[o] = got

    for p, hl in head_lanes.items():
        for i, ln in enumerate(hl):
            put(pfront[p] + i, ln, True)
    # one mark scan for four partitions at a time: a 32-bit word a
    # partition, triggers in its low 16 bits, filtered lanes in its high 16;
    # a marked lane's partition from its index; a trigger's flush rank and
    # a filtered lane's tail slot go to its aux word
    mk = aux & 3
    lane_part = sets % layout
    for p0 in range(0, layout, 4):
        for pp in range(p0, min(p0 + 4, layout)):
            mine = (mk != KEPT) & (lane_part == pp)
            word = mark_scan_prefix(
                np.where(mine, np.where(mk == TRIGGER, 1, 1 << 16), 0), m)
            assert int(mine.sum()) < 1 << 16  # no carry between the halves
            for ln in np.flatnonzero(mine):
                if mk[ln] == TRIGGER:
                    aux[ln] = (word[ln] & 0xFFFF) << 2 | TRIGGER
                else:
                    aux[ln] = (ptail[pp] + pfilt[pp] - 1 - (word[ln] >> 16)) \
                        << 2 | FILTERED
    # emission: one pass over the binned slots
    for r in range(m):
        ln = order[r]
        a, mark = aux[ln], aux[ln] & 3
        if mark == FILTERED:
            continue
        if mark == TRIGGER:  # a consumed arrival's slot may hold it too
            p = int(np.searchsorted(start[:-1:q][:layout], r, side="right")) - 1
            put(pfront[p] + (a >> 2) * slots + slots - 1, ln, True)
            continue
        k = a >> 2
        p = k // q
        if dense[p]:
            continue
        local, nf = r - start[k], nflush[k] * slots
        if local < nf:
            trig = order[start[k] + local // slots * slots + slots - 1]
            put(pfront[p] + (aux[trig] >> 2) * slots + local % slots, ln, True)
        elif local < nf + ndrain[k]:
            put(pfront[p] + (pf[p + 1] - pf[p]) * slots + drain_off[k]
                + local - nf, ln, True)
    # the filtered lanes staged by tail slot over the binned order, then the
    # dead lanes and the tail in one pass
    for ln in np.flatnonzero(aux & 3 == FILTERED):
        order[aux[ln] >> 2] = ln
    for o in range(survivors, span):
        t = o - survivors - (span - m)
        if t < 0:  # a dead lane
            j = m + o - survivors
            o_idx[o], o_val[o], o_pos[o], o_act[o] = idx[j], val[j], j, False
        else:
            put(o, order[t], False)
    assert len(written) == m
    return out


def model_stream(idx, val, n_live, *, w, stats, **kw):
    n = idx.size
    m_all = n if n_live is None else n_live
    parts = []
    for s0 in range(0, n, w):
        m = int(np.clip(m_all - s0, 0, min(w, n - s0)))
        oi, ov, op_, oa = model_window(idx[s0:s0 + w], val[s0:s0 + w], m,
                                       w=w, stats=stats, **kw)
        parts.append((oi, ov, op_ + s0, oa))
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(4))


def oracle_stream(ref, idx, val, n_live, *, w, num_sets, slots, parts, op,
                  round_cap):
    n = idx.size
    m_all = n if n_live is None else n_live
    outs = []
    for s0 in range(0, n, w):
        iw, vw = idx[s0:s0 + w], val[s0:s0 + w]
        m = int(np.clip(m_all - s0, 0, iw.size))
        oi, ov, op_, oa = ref.ragged_oracle(
            ref.hash_reorder_ref_banked, iw, vw, m, num_sets=num_sets,
            slots=slots, filter_op=op, n_partitions=parts,
            round_cap=round_cap)
        outs.append((oi, ov, op_ + s0, oa))
    return tuple(np.concatenate([o[i] for o in outs]) for i in range(4))


def _blocks(num_sets, want):
    """Blocks whose set satisfies ``want(set)``."""
    b = np.arange(1 << 14)
    return b[want(tref.hash_set(b, num_sets))]


def _stream(kind, n, rng, num_sets, w, slots, round_cap):
    if kind == "kron":  # R-MAT destinations in CSR-like order: hub sets
        _, dst, _ = kron_edges(scale=12, edge_factor=16)
        return dst[:n].astype(np.int32)
    pick = lambda pool, k: (pool[rng.integers(0, pool.size, k)] * EPB
                            + rng.integers(0, EPB, k)).astype(np.int32)
    if kind == "cap_trip":  # one set of partition 3 past the cap, the other
        # partitions' sets cold: the fallback without the bypass
        hot = rng.random(n) < (round_cap * slots + w // 20) / w
        return np.where(hot, pick(_blocks(num_sets, lambda s: s == 3)[:2], n),
                        pick(_blocks(num_sets, lambda s: s % 4 != 3), n))
    if kind == "bypass_trip":  # partition 0 holds 45% of each window
        heavy = rng.random(n) < 0.45
        return np.where(heavy, pick(_blocks(num_sets, lambda s: s % 4 == 0), n),
                        pick(_blocks(num_sets, lambda s: s % 4 != 0), n))
    if kind == "one_partition":  # every lane in partition 0's sets
        return pick(_blocks(num_sets, lambda s: s % 4 == 0), n)
    if kind == "full_sets":
        return _full_sets_stream(n, rng, num_sets, w, slots)
    return rng.integers(0, 50_000, n).astype(np.int32)


def _full_sets_stream(n, rng, num_sets, w, slots):
    """Each window: in set 1, ``slots`` distinct indices (a small set that
    flushes at its last arrival); in set 2, ``slots`` arrivals with a
    duplicate (a small set that drains); in set 3, ``slots`` distinct
    indices with three duplicates between them, the last distinct one last
    (a hot set that flushes at its last arrival); the other lanes spread
    over sets 4 and up; the four sequences interleaved at random, each in
    its order."""
    block = {s: _blocks(num_sets, lambda t, s=s: t == s)[0] for s in (1, 2, 3)}
    distinct = lambda s: block[s] * EPB + rng.permutation(EPB)[:slots]
    full = distinct(1)
    dup = distinct(2)
    dup[-1] = dup[0]
    hot = distinct(3)
    hot = np.concatenate([hot[:-1], hot[[0, 1, 0]], hot[-1:]])
    out = []
    for s0 in range(0, n, w):
        span = min(w, n - s0)
        rest = span - full.size - dup.size - hot.size
        filler = (_blocks(num_sets, lambda t: t >= 4)[
            rng.integers(0, 200, rest)] * EPB + rng.integers(0, EPB, rest))
        seqs = [list(full), list(dup), list(hot), list(filler)]
        tags = np.repeat(np.arange(4), [len(q) for q in seqs])
        rng.shuffle(tags)
        out += [seqs[t].pop(0) for t in tags]
    return np.asarray(out, np.int32)


def _payload(dtype, n, rng):
    if dtype == "int32":
        return rng.integers(-1000, 1000, n).astype(np.int32)
    return rng.uniform(0.0, 1.0, n).astype(np.float32)


def _stats():
    return {"trigger_lanes": set(), "sub_steps_after_trigger": 0,
            "bypass": 0, "dense": 0, "small_sets": 0, "packed_steps": 0,
            "small_flushes": 0}


@pytest.mark.parametrize("op", [None, "add", "min", "max"])
@pytest.mark.parametrize("slots", [2, 4, 32])
def test_small_set_walk_equals_the_warp_walk(op, slots):
    """On a set of at most ``slots`` arrivals the match-based single step
    and the warp's batched walk agree, payloads included."""
    rng = np.random.default_rng(slots)
    for length in range(1, slots + 1):
        for distinct in (1, 3, slots):
            idx = rng.integers(0, distinct, length).astype(np.int32) + 64
            val = rng.uniform(0.0, 1.0, length).astype(np.float32)
            pos = np.arange(length)
            stats = {"trigger_lanes": set(), "sub_steps_after_trigger": 0}
            small = _walk_small_set(idx, val, pos, slots, op)
            warp = _walk_set(idx, val, pos, slots, op, stats)
            assert repr(small) == repr(warp)


@pytest.mark.parametrize("op", [None, "add", "min"])
@pytest.mark.parametrize("slots", [2, 8, 32])
def test_packed_small_sets_step_equals_one_set_at_a_time(op, slots):
    """Several small sets in one 32-lane step (their indices disjoint)
    give each set what the warp walk gives it alone, payloads included."""
    rng = np.random.default_rng(100 + slots)
    for _ in range(20):
        lens = []
        while sum(lens) < WARP:
            lens.append(int(rng.integers(1, slots + 1)))
        lens[-1] -= sum(lens) - WARP
        if lens[-1] == 0:
            lens.pop()
        idx, set_of = [], []
        for s, n in enumerate(lens):  # set s: indices 1000 s + [0, slots)
            idx += list(1000 * s + rng.integers(0, slots, n))
            set_of += [s] * n
        idx = np.asarray(idx, np.int32)
        val = rng.uniform(0.0, 1.0, idx.size).astype(np.float32)
        pos = np.arange(idx.size)
        got = _walk_small_step(idx, list(val), pos, set_of, slots, op)
        for s, n in enumerate(lens):
            sel = np.flatnonzero(np.asarray(set_of) == s)
            stats = {"trigger_lanes": set(), "sub_steps_after_trigger": 0}
            want = _walk_set(idx[sel], val[sel], pos[sel], slots, op, stats)
            assert repr(got[s]) == repr(want)


def test_small_sets_pack_into_steps():
    """A chunk's small sets go into 32-lane steps in key order, each step
    as many pending sets as fit; hot, capped and empty sets are skipped."""
    lens = {0: 5, 1: 0, 2: 30, 3: 9, 4: 33, 5: 20, 6: 3, 7: 32}
    small = lambda k: 0 < lens[k] <= 32 and k != 6
    assert list(_small_steps(range(8), lens, 32, small)) == [
        [0], [2], [3, 5], [7]]


def test_mark_scan_layout_is_an_exclusive_prefix():
    """The mark scan's thread layout (``rounds`` runs of 256 lanes a warp,
    eight lanes a thread) composes each lane's exclusive prefix."""
    rng = np.random.default_rng(7)
    for m in (1, 31, 32, 255, 4096, 4097, 5000, 8191, 8192):
        x = rng.integers(0, 3, m) * (1 << 16) + rng.integers(0, 2, m)
        assert np.array_equal(mark_scan_prefix(x, m), np.cumsum(x) - x)


def _assert_equal(got, want):
    for field, a, b in zip(("indices", "payload", "positions", "active"),
                           got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), field


# (geometry, window, round cap): the card tests' small windows and the
# paper's geometry
SMALL = ((64, 8), 1024, 4)
PAPER = ((1024, 32), 8192, 64)


@pytest.mark.parametrize("op,dtype", [(None, "float32"), ("add", "float32"),
                                      ("min", "int32"), ("max", "float32")])
@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("kind", ["wide", "kron", "cap_trip",
                                  "bypass_trip"])
@pytest.mark.parametrize("live", [None, "part"])
def test_window_model_matches_both_oracles(op, dtype, parts, kind, live):
    (num_sets, slots), w, cap = SMALL
    rng = np.random.default_rng(parts * 10 + len(kind))
    n = 2500
    idx = _stream(kind, n, rng, num_sets, w, slots, cap)
    val = _payload(dtype, n, rng)
    n_live = None if live is None else 1900
    kw = dict(w=w, num_sets=num_sets, slots=slots, parts=parts, op=op,
              round_cap=cap)
    stats = _stats()
    got = model_stream(idx, val, n_live, stats=stats, **kw)
    _assert_equal(got, oracle_stream(tref, idx, val, n_live, **kw))
    _assert_equal(got, oracle_stream(jref, idx, val, n_live, **kw))
    if kind == "cap_trip" and op is not None:
        assert stats["dense"] > 0
    if kind == "bypass_trip" and parts == 4:
        assert stats["bypass"] > 0


# the edges of the steps: full sets (a small set that flushes at its last
# arrival, one of `slots` arrivals with a duplicate that drains, a hot set
# that flushes at its last arrival; a round cap none of them trips), every
# lane in one partition, and n_live ending mid-warp (in the first window and
# 13 lanes into the second)
@pytest.mark.parametrize("op,dtype", [("add", "float32"), ("min", "int32"),
                                      (None, "float32")])
@pytest.mark.parametrize("kind,parts,live,cap", [
    ("full_sets", 4, None, 64), ("full_sets", 1, 1900, 64),
    ("one_partition", 4, None, 4), ("one_partition", 2, 2000, 4),
    ("wide", 4, 1000 + 7, 4), ("wide", 2, 1024 + 13, 4)])
def test_window_model_edges(op, dtype, kind, parts, live, cap):
    (num_sets, slots), w, _ = SMALL
    rng = np.random.default_rng(len(kind) + parts)
    n = 2500
    idx = _stream(kind, n, rng, num_sets, w, slots, cap)
    val = _payload(dtype, n, rng)
    kw = dict(w=w, num_sets=num_sets, slots=slots, parts=parts, op=op,
              round_cap=cap)
    stats = _stats()
    got = model_stream(idx, val, live, stats=stats, **kw)
    _assert_equal(got, oracle_stream(tref, idx, val, live, **kw))
    _assert_equal(got, oracle_stream(jref, idx, val, live, **kw))
    if kind == "wide":
        assert stats["packed_steps"] > 0
    if kind == "full_sets":  # set 1 flushes as a small set in every window
        assert stats["small_flushes"] >= (2 if live is None else 1)
        assert stats["trigger_lanes"]  # and set 3 as a hot one
    if kind == "one_partition":
        assert stats["bypass"] >= 2


@pytest.mark.parametrize("kind", ["kron", "cap_trip", "bypass_trip"])
def test_window_model_at_the_paper_geometry(kind):
    """1024 x 32 sets over 4 partitions, 8192-lane windows, round cap 64:
    kron-12's hub sets, a set past 64 x 32 arrivals, a partition past its
    capacity."""
    (num_sets, slots), w, cap = PAPER
    rng = np.random.default_rng(5)
    n = 2 * w + 1000
    idx = _stream(kind, n, rng, num_sets, w, slots, cap)
    val = _payload("float32", n, rng)
    kw = dict(w=w, num_sets=num_sets, slots=slots, parts=4, op="add",
              round_cap=cap)
    stats = _stats()
    got = model_stream(idx, val, n - 700, stats=stats, **kw)
    _assert_equal(got, oracle_stream(tref, idx, val, n - 700, **kw))
    _assert_equal(got, oracle_stream(jref, idx, val, n - 700, **kw))
    assert stats["small_sets"] > 0 and stats["packed_steps"] > 0
    # the two full windows trip; the ragged third (300 live lanes) may not
    assert (stats["dense"] >= 2) == (kind == "cap_trip")
    assert (stats["bypass"] >= 2) == (kind == "bypass_trip")


def _family_oracle(ref, idx, val, n_live, table, **kw):
    """The tagged oracle: the windowed banked oracle's layout (it does not
    depend on the op), its add payloads on add-family lanes and its min
    payloads on min-family lanes."""
    add = oracle_stream(ref, idx, val, n_live, op="add", **kw)
    low = oracle_stream(ref, idx, val, n_live, op="min", **kw)
    fam = table[np.clip(add[0], 0, table.size - 1)]
    return add[0], np.where(fam, add[1], low[1]), add[2], add[3]


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("kind,parts,live", [
    ("kron", 4, None), ("cap_trip", 4, 1900), ("bypass_trip", 4, None),
    ("full_sets", 1, None), ("wide", 2, 1024 + 13)])
def test_window_model_tagged_matches_both_oracles(dtype, kind, parts, live):
    """The windowed body tagged: each fold under its survivor's family;
    held against both packages' oracles per family, on hot sets, the
    round-cap fallback, the bypass, full small sets and a ragged window."""
    (num_sets, slots), w, cap = SMALL
    rng = np.random.default_rng(parts * 7 + len(kind))
    n = 2500
    idx = _stream(kind, n, rng, num_sets, w, slots, cap)
    val = _payload(dtype, n, rng)
    table = rng.random(int(idx.max()) + 2) < 0.5
    kw = dict(w=w, num_sets=num_sets, slots=slots, parts=parts,
              round_cap=cap)
    stats = _stats()
    got = model_stream(idx, val, live, stats=stats, op=table, **kw)
    _assert_equal(got, _family_oracle(tref, idx, val, live, table, **kw))
    _assert_equal(got, _family_oracle(jref, idx, val, live, table, **kw))
    if kind == "cap_trip":
        assert stats["dense"] > 0
    if kind == "bypass_trip":
        assert stats["bypass"] > 0

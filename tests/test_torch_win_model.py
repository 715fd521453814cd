"""The windowed body of kernel B3, modelled in numpy and held against the
banked IRU hash oracles of both packages.

B3's windowed body (``win_reorder`` in ``kernels/iru_reorder/iru_reorder.cu``)
reorders each window of ``w`` lanes in one CTA, in shared memory:

* **bin**: a set histogram of the window's live lanes; the partition counts
  decide the bank bypass (a partition past ``partition_capacity(m, P)``
  lays the window out as one partition); a set past ``round_cap * slots``
  arrivals sends its partition to the dense fallback; a bitonic sort of
  64-bit keys ``(partition, set within it or the biased index in a capped
  partition, lane)`` gives the binned order;
* **walk**: each hash partition's sets, the grain chosen from the set
  histogram: a set of at most ``slots`` arrivals fills at most once, so one
  thread walks it in a single round (``_walk_small_set``); a larger one is
  walked by a warp with the walk of the whole-stream body (``_walk_set`` of
  ``tests/test_torch_hash_walk.py`` models it); kept lanes take their
  merged payloads, triggers and filtered lanes are marked by lane;
* **fallback**: in a capped partition each run of equal indices of the
  binned order folds into its first lane, in lane (stream) order;
* **emit**: scans in the kernel's order -- drain offsets over the sets in
  partition-major order, the capped partitions' heads over the binned
  order, and, a partition at a time, the triggers' flush ranks and the
  filtered lanes' tail slots over the lanes -- place each partition's
  front, the dead lanes, then each partition's tail.

``model_window`` follows those steps, and ``model_stream`` offsets each
window's positions by its start.  It is held exactly (payloads too: both
fold in stream order) against ``ragged_oracle(hash_reorder_ref_banked)`` of
the port's ``repro_torch.kernels.iru_reorder.ref`` and the reference's
``repro.kernels.iru_reorder.ref``, window by window, on hot-set (kron),
round-cap-trip and bypass-trip windows.  The card tests run the kernel
itself (``tests/test_torch_kernels.py``, marked ``gpu``).
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.kernels.iru_reorder import ref as jref
from repro_torch.graphs.generators import kron_edges
from repro_torch.kernels.iru_reorder import ref as tref
from test_torch_hash_walk import _walk_set

EPB = 32
LANE_BITS, PART_SHIFT = 13, 45
_FOLD = {"add": lambda a, b: a + b, "min": min, "max": max}


def _walk_small_set(idx, val, pos, slots, op):
    """One thread's single-round walk of a set of at most ``slots``
    arrivals: an arrival whose index a kept entry holds folds into it, in
    stream order; the set flushes when all ``slots`` arrivals are kept.
    Returns what ``_walk_set`` returns."""
    res, filtered = [], []
    for i, v, p in zip(idx, val, pos):
        hit = next((e for e in res if e[0] == i), None) if op else None
        if hit is None:
            res.append([i, v, p])
        else:
            hit[1] = _FOLD[op](hit[1], v)
            filtered.append(p)
    if len(res) == slots:
        return [(res[-1][2], res)], [], filtered
    return [], res, filtered


def model_window(idx, val, m, *, num_sets, slots, parts, op, round_cap,
                 stats):
    """One window, its first ``m`` lanes live, as the windowed body lays it
    out (positions window-local)."""
    span = idx.size
    out = [idx.copy(), val.copy(), np.arange(span, dtype=np.int32),
           np.zeros(span, bool)]
    if m == 0:  # a dead window is a copy
        return out
    live_idx = idx[:m]
    s_val = val[:m].copy()
    sets = tref.hash_set(live_idx // np.int32(EPB), num_sets)
    cnt = np.bincount(sets, minlength=num_sets)
    # bin: the bypass, the capped partitions, the sort keys
    layout = parts
    if parts > 1:
        pc = np.bincount(sets % parts, minlength=parts)
        if pc.max() > tref.partition_capacity(m, parts):
            layout = 1
            stats["bypass"] += 1
    q = num_sets // layout
    dense = np.zeros(layout, bool)
    if op is not None and round_cap is not None:
        for s in np.flatnonzero(cnt > round_cap * slots):
            dense[s % layout] = True
    stats["dense"] += int(dense.any())
    part = sets % layout
    mid = np.where(dense[part],
                   live_idx.view(np.uint32).astype(np.uint64) ^ (1 << 31),
                   (sets // layout).astype(np.uint64))
    keys = np.sort((part.astype(np.uint64) << PART_SHIFT)
                   | (mid << LANE_BITS) | np.arange(m, dtype=np.uint64))
    lanes = (keys & ((1 << LANE_BITS) - 1)).astype(np.int64)
    set_of_key = (np.arange(num_sets) % q) * layout + np.arange(num_sets) // q
    start = np.concatenate(([0], np.cumsum(cnt[set_of_key])))
    # walk: every set of a hash partition, kept entries in emission order
    mark = np.zeros(m, np.int8)  # 0 kept, 1 trigger, 2 filtered
    groups = {}                  # key -> (flush groups, drain group)
    for k in range(num_sets):
        c = cnt[set_of_key[k]]
        if c == 0 or dense[k // q]:
            continue
        arr = lanes[start[k]:start[k] + c]
        args = (live_idx[arr], s_val[arr], arr, slots, op)
        if c <= slots:
            flushes, drain, filtered = _walk_small_set(*args)
            stats["small_sets"] += 1
        else:
            flushes, drain, filtered = _walk_set(*args, stats)
        for _, res in flushes:
            mark[res[-1][2]] = 1  # the trigger takes the group's last slot
        mark[filtered] = 2
        for entry in [e for _, res in flushes for e in res] + drain:
            s_val[entry[2]] = entry[1]
        groups[k] = ([[e[2] for e in res] for _, res in flushes],
                     [e[2] for e in drain])
    # fallback: a capped partition's runs fold into their first lanes
    run_key = keys >> LANE_BITS
    head = np.zeros(m, bool)
    for r in range(m):
        if not dense[keys[r] >> PART_SHIFT]:
            continue
        if r and run_key[r - 1] == run_key[r]:
            continue
        head[r] = True
        acc = s_val[lanes[r]]
        r2 = r + 1
        while r2 < m and run_key[r2] == run_key[r]:
            mark[lanes[r2]] = 2
            acc = _FOLD[op](acc, s_val[lanes[r2]])
            r2 += 1
        s_val[lanes[r]] = acc
    # emit: drain offsets and flush counts in partition-major set order
    nflush = np.array([len(groups[k][0]) if k in groups else 0
                       for k in range(num_sets)])
    ndrain = np.array([len(groups[k][1]) if k in groups else 0
                       for k in range(num_sets)])
    drain_ex = np.concatenate(([0], np.cumsum(ndrain)))
    flush_ex = np.concatenate(([0], np.cumsum(nflush)))
    heads_of = np.bincount((keys[head] >> PART_SHIFT).astype(np.int64),
                           minlength=layout)
    lanes_of = (np.array([m]) if layout == 1
                else np.bincount(part, minlength=layout))
    kept = np.where(dense, heads_of,
                    (flush_ex[(np.arange(layout) + 1) * q]
                     - flush_ex[np.arange(layout) * q]) * slots
                    + drain_ex[(np.arange(layout) + 1) * q]
                    - drain_ex[np.arange(layout) * q])
    survivors = int(kept.sum())
    pfront = np.concatenate(([0], np.cumsum(kept)[:-1]))
    pfilt = lanes_of - kept
    ptail = span - (m - survivors) + np.concatenate(([0],
                                                     np.cumsum(pfilt)[:-1]))
    phead = np.concatenate(([0], np.cumsum(np.where(dense, heads_of, 0))[:-1]))
    o_idx, o_val, o_pos, o_act = out

    def put(o, lane, active):
        o_idx[o], o_val[o], o_pos[o], o_act[o] = (live_idx[lane],
                                                  s_val[lane], lane, active)

    head_rank = np.cumsum(head) - head
    for r in np.flatnonzero(head):
        p = keys[r] >> PART_SHIFT
        put(pfront[p] + head_rank[r] - phead[p], lanes[r], True)
    trig_rank = np.zeros(m, np.int64)
    for p in range(layout):  # one scan over the lanes a partition
        mine = part == p
        trig = mine & (mark == 1)
        filt = mine & (mark == 2)
        trig_rank[trig] = (np.cumsum(trig) - trig)[trig]
        f_rank = (np.cumsum(filt) - filt)[filt]
        for lane, r in zip(np.flatnonzero(filt), f_rank):
            put(ptail[p] + pfilt[p] - 1 - r, lane, False)
    for k, (flushes, drain) in groups.items():
        p = k // q
        for grp in flushes:
            for j, lane in enumerate(grp):
                put(pfront[p] + trig_rank[grp[-1]] * slots + j, lane, True)
        for j, lane in enumerate(drain):
            put(pfront[p] + (flush_ex[(p + 1) * q] - flush_ex[p * q]) * slots
                + drain_ex[k] - drain_ex[p * q] + j, lane, True)
    for j in range(m, span):  # the dead lanes, between fronts and tails
        o = survivors + j - m
        o_idx[o], o_val[o], o_pos[o], o_act[o] = idx[j], val[j], j, False
    return out


def model_stream(idx, val, n_live, *, w, stats, **kw):
    n = idx.size
    m_all = n if n_live is None else n_live
    parts = []
    for s0 in range(0, n, w):
        m = int(np.clip(m_all - s0, 0, min(w, n - s0)))
        oi, ov, op_, oa = model_window(idx[s0:s0 + w], val[s0:s0 + w], m,
                                       stats=stats, **kw)
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
    return rng.integers(0, 50_000, n).astype(np.int32)


def _payload(dtype, n, rng):
    if dtype == "int32":
        return rng.integers(-1000, 1000, n).astype(np.int32)
    return rng.uniform(0.0, 1.0, n).astype(np.float32)


@pytest.mark.parametrize("op", [None, "add", "min", "max"])
@pytest.mark.parametrize("slots", [2, 4, 32])
def test_small_set_walk_equals_the_warp_walk(op, slots):
    """On a set of at most ``slots`` arrivals the thread's single round and
    the warp's batched walk agree, payloads included."""
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
    stats = {"trigger_lanes": set(), "sub_steps_after_trigger": 0,
             "bypass": 0, "dense": 0, "small_sets": 0}
    got = model_stream(idx, val, n_live, stats=stats, **kw)
    _assert_equal(got, oracle_stream(tref, idx, val, n_live, **kw))
    _assert_equal(got, oracle_stream(jref, idx, val, n_live, **kw))
    if kind == "cap_trip" and op is not None:
        assert stats["dense"] > 0
    if kind == "bypass_trip" and parts == 4:
        assert stats["bypass"] > 0


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
    stats = {"trigger_lanes": set(), "sub_steps_after_trigger": 0,
             "bypass": 0, "dense": 0, "small_sets": 0}
    got = model_stream(idx, val, n - 700, stats=stats, **kw)
    _assert_equal(got, oracle_stream(tref, idx, val, n - 700, **kw))
    _assert_equal(got, oracle_stream(jref, idx, val, n - 700, **kw))
    assert stats["small_sets"] > 0
    # the two full windows trip; the ragged third (300 live lanes) may not
    assert (stats["dense"] >= 2) == (kind == "cap_trip")
    assert (stats["bypass"] >= 2) == (kind == "bypass_trip")

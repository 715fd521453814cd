"""The whole-stream body of kernel B3 stage by stage, modelled in numpy and
held against the IRU hash oracles of both packages.

B3's whole-stream body (``run`` in ``kernels/iru_reorder/iru_reorder.cu``)
works on the live prefix ``[0, n_live)`` only:

* **bin**: a stable counting sort of the live lanes by set;
* **walk**: untagged, one warp a set folds as it walks (``batched_walk`` of
  ``tests/test_torch_hash_walk.py`` models it); tagged, the walk is split:
  the **chain** (one warp a set, indices and positions only) gives every
  arrival its code (the slot it takes, or the slot it folds into) and its
  mark (kept, trigger or filtered, with its set's partition ``set % P``),
  and each flush group its end; the **fold** (one warp a group, all groups
  independent) takes a group's arrivals 32 at a time, each slot's arrivals
  of a step in lane order, the kept one first, and folds the filtered ones
  under the slot's family;
* **emit**: one single-pass **mark scan** over the live lanes in stream
  order (4096-lane tiles ticketed in order, decoupled look-back over
  64-bit words of 31-bit trigger and filtered counts, up to eight
  partitions a pass, the bank bypass decided first) gives each trigger its
  flush rank and each filtered lane its tail slot; the dead lanes go to
  ``[survivors, survivors + n - n_live)`` in one copy; each group goes to
  its partition's front.

With a round cap (and a merge) the body first decides, from the set
counts and after the bank bypass, which partitions are capped (one of
their sets holds more than ``round_cap * slots`` live lanes); the walk
leaves their sets, and the **fallback** takes their live lanes: a stable
sort by index (LSD passes of 10-bit digits of the sign-flipped index, a
pass skipped when every key shares its digit), a **dense scan** over the
sorted lanes that ranks each run's first lane in its partition's front
and marks every lane kept (a first) or filtered at its stream position
(the mark scan then gives the filtered lanes their tail slots), and the
runs' folds in sorted (stream) order.

``model_body`` follows those steps and is held exactly (payloads included:
every fold adds in stream order) against ``ragged_oracle`` of
``hash_reorder_ref_banked`` of the port's ``repro_torch.kernels.iru_reorder.ref``
and the reference's ``repro.kernels.iru_reorder.ref``, with tagged families
(the oracle run with ``add`` on the add family's lanes and ``min`` on the
min family's), a hub set spanning many flush groups, and ``n_live`` well
below ``n``.  ``mark_scan`` runs the scan's tiles under a seeded schedule
(tiles interleaved, look-backs that find their predecessors not yet
published and wait) and is held against one pass a partition.  The card
tests run the kernel itself (``tests/test_torch_kernels.py``, marked
``gpu``).
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.kernels.iru_reorder import ref as jref
from repro_torch.kernels.iru_reorder import ref as tref

WARP = 32
EPB = 32
KEPT, TRIGGER, FILTERED = 0, 1, 2
TILE_THREADS, TILE_ITEMS = 256, 16  # the kernel's scan tile: 4096 lanes
MARK_WORDS = 8                      # partitions one mark-scan pass counts
VALID = 1 << 63


def _fold(op, a, b, add):
    """A slot's fold of one filtered arrival, in the payload's dtype."""
    if op == "tagged":
        op = "add" if add else "min"
    if op == "add":
        return (a + b).astype(a.dtype)
    if op == "min":
        return min(a, b)
    return max(a, b)


# ------------------------------------------------------------------ chain
def chain_set(idx, slots, op):
    """The chain of one set's arrivals (stream order): per arrival its code
    ``(slot, kept)`` and kind, the end of each flush group (the arrival
    after its trigger) and the drain group's size."""
    n = len(idx)
    code = [None] * n
    kind = [KEPT] * n
    gend = []
    res: list = []  # resident indices, by slot
    for k0 in range(0, n, WARP):
        ei = idx[k0:k0 + WARP]
        steps, a = len(ei), 0
        while a < steps:
            sub = range(a, steps)
            own = ({t: res.index(ei[t]) for t in sub if ei[t] in res}
                   if op is not None else {})
            new = [t for t in sub if t not in own and (
                op is None or all(ei[u] != ei[t] for u in range(a, t)))]
            need = slots - len(res)
            trig = len(new) >= need
            last = new[need - 1] if trig else steps - 1
            ins = [t for t in new if t <= last]
            base = len(res)
            for r, t in enumerate(ins):
                code[k0 + t] = (base + r, True)
                res.append(ei[t])
            for t in range(a, last + 1):
                if t in ins:
                    continue
                j = own.get(t)
                if j is None:  # a duplicate of a new arrival of the sub-step
                    j = base + next(r for r, u in enumerate(ins)
                                    if ei[u] == ei[t])
                code[k0 + t] = (j, False)
                kind[k0 + t] = FILTERED
            if trig:
                kind[k0 + last] = TRIGGER
                gend.append(k0 + last + 1)
                res = []
            a = last + 1
    return code, kind, gend, len(res)


def fold_group(idx, val, pos, fam, code, lo, hi, op, stats):
    """fold_emit's warp on one group's arrivals [lo, hi): 32 a step, each
    slot's arrivals of the step (a ballot a bit of the slot) taken in
    lane order by the slot's lane.  Returns the group's entries by slot."""
    slot = {}
    for k0 in range(lo, hi, WARP):
        step = range(k0, min(k0 + WARP, hi))
        owners: dict = {}
        for k in step:
            owners.setdefault(code[k][0], []).append(k)
        stats["fold_rounds"] = max(stats.get("fold_rounds", 0),
                                   max(len(v) for v in owners.values()))
        for j, ks in owners.items():
            for k in ks:
                if code[k][1]:
                    slot[j] = [idx[k], val[k], pos[k], fam[k]]
                else:
                    r = slot[j]
                    r[1] = _fold(op, r[1], val[k], r[3])
    return [slot[j][:3] for j in range(len(slot))]


# -------------------------------------------------------------- mark scan
def _pack(trig, filt):
    return (int(trig) << 31) | int(filt)


def mark_scan(kind, part, m, parts, tails, filtered, rng, *,
              threads=TILE_THREADS, items=TILE_ITEMS, conc=6, stats=None):
    """The single-pass mark scan over lanes [0, m), one pass a
    ``MARK_WORDS`` partitions: returns ``(rank, slot)``, each trigger's
    flush rank within its partition and each filtered lane's tail slot.

    Tiles of ``threads * items`` lanes take tickets in order; ``rng`` then
    interleaves the first ``conc`` unfinished ones (``conc=0``: every tile
    counts first, then tile 0 settles and the others look back from the
    last, which makes the look-backs cross whole windows): a tile
    publishes its aggregate, looks back in windows of 32 predecessors (a
    window settles once every tile up to the nearest one with an inclusive
    prefix has published; else the tile waits and another one moves),
    publishes its inclusive prefix and places its lanes a warp's 32-lane
    step at a time, ranked by ballots."""
    stats = {} if stats is None else stats
    tile = threads * items
    tiles = -(-m // tile)
    rank, slot = {}, {}
    for p0 in range(0, parts, MARK_WORDS):
        w = min(MARK_WORDS, parts - p0)
        agg = [None] * tiles   # published words (valid bit set), by tile
        incl = [None] * tiles
        state = {}
        pending = list(range(tiles))
        while pending:
            if conc:
                t = pending[rng.integers(0, min(len(pending), conc))]
            else:
                fresh = [u for u in pending if u not in state]
                t = fresh[0] if fresh else pending[0] if pending[0] == 0 \
                    else pending[-1]
            st = state.setdefault(t, {"phase": 0})
            if st["phase"] == 0:  # count, publish the aggregate
                base = t * tile
                lanes = np.arange(base, min(base + tile, m))
                warp_tot = np.zeros((threads // WARP, w, 2), np.int64)
                for q in range(w):
                    for k, kd in enumerate((TRIGGER, FILTERED)):
                        hit = (kind[lanes] == kd) & (part[lanes] == p0 + q)
                        per_warp = np.zeros(tile, bool)
                        per_warp[:lanes.size] = hit
                        warp_tot[:, q, k] = per_warp.reshape(
                            threads // WARP, -1).sum(1)
                st["warp_tot"] = warp_tot
                tot = warp_tot.sum(0)
                st["agg"] = [_pack(*tot[q]) for q in range(w)]
                if t > 0:
                    agg[t] = [v | VALID for v in st["agg"]]
                st.update(phase=1, top=t - 1, acc=[0] * w)
                continue
            if st["phase"] == 1:  # look back, one 32-tile window a move
                if t == 0:
                    st["phase"] = 2
                else:
                    lanes = [st["top"] - i for i in range(WARP)]
                    got = []
                    for u in lanes:
                        if u < 0:
                            got.append((2, [0] * w))
                        elif incl[u] is not None:
                            got.append((2, [v & ~VALID for v in incl[u]]))
                        elif agg[u] is not None:
                            got.append((1, [v & ~VALID for v in agg[u]]))
                        else:
                            got.append((0, None))
                    first = next((i for i, g in enumerate(got) if g[0] == 2),
                                 WARP)
                    need = got[:first + 1]
                    if any(g[0] == 0 for g in need):
                        stats["waits"] = stats.get("waits", 0) + 1
                        continue  # not ready: another tile moves
                    for _, v in need:
                        st["acc"] = [a + x for a, x in zip(st["acc"], v)]
                    if first == WARP:
                        st["top"] -= WARP
                        stats["windows"] = stats.get("windows", 0) + 1
                        continue
                    st["phase"] = 2
                incl[t] = [(e + a) | VALID
                           for e, a in zip(st["acc"], st["agg"])]
                continue
            # place: each warp's 32-lane steps, running counts from the
            # exclusive prefix and the earlier warps' sums
            base = t * tile
            before_warps = np.cumsum(st["warp_tot"], 0) - st["warp_tot"]
            for wid in range(threads // WARP):
                rt = [(st["acc"][q] >> 31) + before_warps[wid, q, 0]
                      for q in range(w)]
                rf = [(st["acc"][q] & 0x7FFFFFFF) + before_warps[wid, q, 1]
                      for q in range(w)]
                for step in range(items):
                    ls = base + wid * WARP * items + step * WARP + np.arange(
                        WARP)
                    ok = ls < m
                    kd = np.where(ok, kind[np.minimum(ls, m - 1)], KEPT)
                    pt = np.where(ok, part[np.minimum(ls, m - 1)], -1) - p0
                    for q in range(w):
                        tm = (kd == TRIGGER) & (pt == q)
                        fm = (kd == FILTERED) & (pt == q)
                        for lane in np.flatnonzero(tm):
                            rank[int(ls[lane])] = rt[q] + int(tm[:lane].sum())
                        for lane in np.flatnonzero(fm):
                            before = rf[q] + int(fm[:lane].sum())
                            slot[int(ls[lane])] = (tails[p0 + q]
                                                   + filtered[p0 + q] - 1
                                                   - before)
                        rt[q] += int(tm.sum())
                        rf[q] += int(fm.sum())
            pending.remove(t)
    return rank, slot


def mark_passes(kind, part, m, parts, tails, filtered):
    """The per-partition passes the scan replaces: each partition's
    exclusive scans of its triggers and filtered lanes over stream order."""
    rank, slot = {}, {}
    for p in range(parts):
        trig = np.flatnonzero((kind[:m] == TRIGGER) & (part[:m] == p))
        filt = np.flatnonzero((kind[:m] == FILTERED) & (part[:m] == p))
        rank.update({int(j): r for r, j in enumerate(trig)})
        slot.update({int(j): tails[p] + filtered[p] - 1 - r
                     for r, j in enumerate(filt)})
    return rank, slot


# ------------------------------------------------------------------- body
SORT_BITS = 10  # the kernel's digit


def digit_sort(x, pos, stats):
    """The fallback's sort of the capped lanes (``x`` their indices and
    ``pos`` their stream positions, in stream order): LSD passes over
    10-bit digits of the sign-flipped index, stable; a later pass whose
    digit every key shares is skipped (it would move nothing)."""
    keys = (x.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000
    diff = int(np.bitwise_or.reduce(keys)) ^ int(np.bitwise_and.reduce(keys))
    mask = (1 << SORT_BITS) - 1
    for p in range(-(-32 // SORT_BITS)):
        if p > 0 and (diff >> (SORT_BITS * p)) & mask == 0:
            stats["skipped"] = stats.get("skipped", 0) + 1
            continue
        order = np.argsort((keys >> (SORT_BITS * p)) & mask, kind="stable")
        keys, x, pos = keys[order], x[order], pos[order]
    return x, pos


def dense_scan(x, pos, sets, parts):
    """Over the sorted capped lanes: each run's first lane's rank in its
    partition's front, every lane's mark (kept: a first; filtered) and
    partition at its stream position, and each partition's survivors."""
    first = np.ones(x.size, bool)
    first[1:] = x[1:] != x[:-1]
    part = sets % parts
    rank = np.zeros(x.size, np.int64)
    heads = np.zeros(parts, np.int64)
    for j in np.flatnonzero(first):
        rank[j] = heads[part[j]]
        heads[part[j]] += 1
    return first, rank, heads, part


def model_body(idx, val, n_live, *, num_sets, slots, parts, op, table=None,
               rng=None, stats=None, threads=TILE_THREADS,
               items=TILE_ITEMS, round_cap=None):
    """The whole-stream body's layout, stage by stage (tagged: ``op`` is
    "tagged" and ``table`` the families, True = add; ``round_cap``: capped
    partitions take the fallback)."""
    stats = {} if stats is None else stats
    rng = np.random.default_rng(0) if rng is None else rng
    idx = np.asarray(idx, np.int32)
    n = idx.size
    m = int(np.clip(n_live, 0, n))
    fam = (table[np.clip(idx, 0, table.size - 1)] if table is not None
           else np.zeros(n, bool))
    merge = None if op is None else op
    sets = tref.hash_set(idx[:m] // np.int32(EPB), num_sets)
    order = np.argsort(sets, kind="stable")           # bin
    start = np.searchsorted(sets[order], np.arange(num_sets + 1))
    counts = np.bincount(sets % parts, minlength=parts)
    if parts > 1 and m and counts.max() > tref.partition_capacity(m, parts):
        parts = 1                                     # bank bypass
        stats["bypass"] = stats.get("bypass", 0) + 1
    capped = np.zeros(parts, bool)                    # the round cap
    if round_cap is not None and op is not None:
        hot = np.flatnonzero(np.bincount(sets, minlength=num_sets)
                             > round_cap * slots)
        capped[hot % parts] = True
        stats["capped"] = stats.get("capped", 0) + int(capped.sum())
    kind = np.zeros(m, np.int64)
    part = np.zeros(m, np.int64)
    code = [None] * m
    gends, drains = {}, {}
    for s in range(num_sets):                         # chain
        arr = order[start[s]:start[s + 1]]
        if capped[s % parts]:  # the fallback's
            gends[s], drains[s] = [], 0
            continue
        c, k, gend, drained = chain_set(list(idx[arr]), slots, merge)
        kind[arr] = k
        part[arr] = s % parts
        for a, cc in zip(range(start[s], start[s + 1]), c):
            code[a] = cc
        gends[s], drains[s] = gend, drained
    live_c = np.flatnonzero(capped[sets % parts])    # the fallback
    sx, spos = digit_sort(idx[live_c], live_c, stats)
    first, srank, heads, spart = dense_scan(
        sx, spos, tref.hash_set(sx // np.int32(EPB), num_sets), parts)
    kind[spos] = np.where(first, KEPT, FILTERED)
    part[spos] = spart
    q = num_sets // parts
    keys = [(k % q) * parts + k // q for k in range(num_sets)]
    pf = np.zeros(parts + 1, np.int64)  # [p + 1]: partition p's flush groups
    pd = np.zeros(parts + 1, np.int64)  # [p + 1]: its drained entries
    drain_off = {}
    for k, s in enumerate(keys):                      # finalize
        p = k // q
        drain_off[s] = pd[p + 1]
        pd[p + 1] += drains[s]
        pf[p + 1] += len(gends[s])
    lanes = (np.bincount(sets % parts, minlength=parts) if parts > 1
             else np.array([m]))
    kept = np.where(capped, heads, pf[1:] * slots + pd[1:])
    front = np.concatenate([[0], np.cumsum(kept)[:-1]])
    survivors = int(kept.sum())
    filtered = lanes - kept
    tails = n - (m - survivors) + np.concatenate(
        [[0], np.cumsum(filtered)[:-1]])
    rank, slot = mark_scan(kind, part, m, parts, tails, filtered, rng,
                           threads=threads, items=items, stats=stats)
    out_idx = np.zeros(n, np.int32)
    out_val = np.zeros(n, val.dtype)
    out_pos = np.zeros(n, np.int32)
    out_act = np.zeros(n, bool)
    for j, o in slot.items():                         # filtered tail
        out_idx[o], out_val[o], out_pos[o] = idx[j], val[j], j
    d = np.arange(m, n)                               # dead lanes
    out_idx[survivors + d - m], out_val[survivors + d - m] = idx[d], val[d]
    out_pos[survivors + d - m] = d
    bidx, bval, bpos = idx[order], val[order], order
    bfam = fam[order]
    for k, s in enumerate(keys):                      # fold + emit
        p = k // q
        lo = 0
        ends = gends[s] + ([start[s + 1] - start[s]] if drains[s] else [])
        for g, hi in enumerate(ends):
            entries = fold_group(bidx[start[s]:], bval[start[s]:],
                                 bpos[start[s]:], bfam[start[s]:],
                                 code[start[s]:], lo, hi, op, stats)
            if g < len(gends[s]):
                o = front[p] + rank[int(bpos[start[s] + hi - 1])] * slots
            else:
                o = front[p] + pf[p + 1] * slots + drain_off[s]
            for e, (i, v, ps) in enumerate(entries):
                out_idx[o + e], out_val[o + e], out_pos[o + e] = i, v, ps
                out_act[o + e] = True
            lo = hi
        stats["groups"] = stats.get("groups", 0) + len(ends)
        stats["most_groups"] = max(stats.get("most_groups", 0), len(ends))
    sval = val[spos]                                  # the runs' folds
    for j in np.flatnonzero(first):
        acc = sval[j]
        r = j + 1
        while r < sx.size and sx[r] == sx[j]:
            acc = _fold(op, acc, sval[r], fam[spos[j]])
            r += 1
        o = front[spart[j]] + srank[j]
        out_idx[o], out_val[o], out_pos[o], out_act[o] = sx[j], acc, \
            spos[j], True
        stats["longest_run"] = max(stats.get("longest_run", 0), r - j)
    return out_idx, out_val, out_pos, out_act


def oracle(ref, idx, val, n_live, *, num_sets, slots, parts, op,
           table=None, round_cap=None):
    """``ragged_oracle(hash_reorder_ref_banked)``; tagged, its add result on
    add lanes and its min result on min lanes (the layout is the op's)."""
    kw = dict(num_sets=num_sets, slots=slots, n_partitions=parts,
              round_cap=round_cap)
    if op != "tagged":
        return ref.ragged_oracle(ref.hash_reorder_ref_banked, idx, val,
                                 n_live, filter_op=op, **kw)
    add = ref.ragged_oracle(ref.hash_reorder_ref_banked, idx, val, n_live,
                            filter_op="add", **kw)
    low = ref.ragged_oracle(ref.hash_reorder_ref_banked, idx, val, n_live,
                            filter_op="min", **kw)
    for a, b in zip((add[0], add[2], add[3]), (low[0], low[2], low[3])):
        assert np.array_equal(a, b)
    f = table[np.clip(add[0], 0, table.size - 1)]
    return add[0], np.where(f, add[1], low[1]), add[2], add[3]


def _assert_equal(got, want):
    for field, a, b in zip(("indices", "payload", "positions", "active"),
                           got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def _stream(kind, n, rng, num_sets):
    if kind == "hub":  # a hub block's 32 indices among spread ones: one set
        idx = rng.integers(0, 3000, n)   # flushes again and again
        hub = rng.random(n) < 0.4
        idx[hub] = 64 + rng.integers(0, 32, int(hub.sum()))
        return idx.astype(np.int32)
    if kind == "family_set":  # one set's blocks all of one family
        one = _family_blocks(num_sets)
        idx = rng.integers(0, 4000, n)
        sel = rng.random(n) < 0.5
        idx[sel] = (one[rng.integers(0, one.size, int(sel.sum()))] * 32
                    + rng.integers(0, 32, int(sel.sum())))
        return idx.astype(np.int32)
    if kind == "negative":  # indices of both signs: the sort's sign bit
        return rng.integers(-3000, 3000, n).astype(np.int32)
    if kind == "one_partition":  # every lane's set in partition 0 of 4
        blocks = np.arange(1 << 12)
        pool = blocks[tref.hash_set(blocks, num_sets) % 4 == 0][:200]
        return (pool[rng.integers(0, pool.size, n)] * 32
                + rng.integers(0, 32, n)).astype(np.int32)
    return rng.integers(0, 6000, n).astype(np.int32)  # wide


def _family_blocks(num_sets):
    blocks = np.arange(1 << 12)
    return blocks[tref.hash_set(blocks, num_sets) == 3][:4]


def _table(idx, rng, kind, num_sets):
    table = rng.random(int(np.abs(idx).max()) + 2) < 0.5
    if kind == "family_set":  # set 3's blocks all in the min family
        for b in _family_blocks(num_sets):
            table[b * 32:(b + 1) * 32] = False
    return table


# -------------------------------------------------------------------- tests
@pytest.mark.parametrize("op,dtype", [("tagged", "float32"),
                                      ("tagged", "int32"),
                                      ("add", "float32"), ("min", "int32"),
                                      (None, "float32")])
@pytest.mark.parametrize("kind,parts", [("hub", 1), ("hub", 4),
                                        ("family_set", 2), ("wide", 8),
                                        ("one_partition", 4)])
def test_chain_then_fold_matches_both_oracles(op, dtype, kind, parts):
    """The chain-then-fold body equals both packages' oracles bit for bit,
    ``n_live`` well below ``n``; the hub set spans many flush groups."""
    num_sets, slots = (64, 8) if kind != "hub" else (16, 4)
    rng = np.random.default_rng(len(kind) * 10 + parts)
    n = 3000
    idx = _stream(kind, n, rng, num_sets)
    val = (rng.uniform(0.0, 1.0, n).astype(np.float32) if dtype == "float32"
           else rng.integers(-1000, 1000, n).astype(np.int32))
    table = _table(idx, rng, kind, num_sets) if op == "tagged" else None
    live = n * 2 // 3 + 1  # n - n_live: not a multiple of 4 or 16
    kw = dict(num_sets=num_sets, slots=slots, parts=parts, op=op,
              table=table)
    stats = {}
    got = model_body(idx, val, live, stats=stats, threads=32, items=4,
                     rng=np.random.default_rng(parts), **kw)
    _assert_equal(got, oracle(tref, idx, val, live, **kw))
    _assert_equal(got, oracle(jref, idx, val, live, **kw))
    if kind == "hub":
        assert stats["most_groups"] > 20
    if kind == "one_partition":
        assert stats.get("bypass")
    assert stats["waits"] > 0


def test_chain_then_fold_at_the_kernel_tile_and_geometry():
    """1024 x 32 sets over 4 partitions, the kernel's 4096-lane scan tile,
    tagged families from ``(idx >> 11) & 1``, a quarter of the lanes live."""
    rng = np.random.default_rng(11)
    n = 14_000
    idx = (rng.zipf(1.3, n) % (1 << 13)).astype(np.int32)
    val = rng.uniform(0.0, 1.0, n).astype(np.float32)
    table = ((np.arange((1 << 13) + 1) >> 11) & 1).astype(bool)
    kw = dict(num_sets=1024, slots=32, parts=4, op="tagged", table=table)
    for live in (n // 4 + 3, n):
        got = model_body(idx, val, live, **kw)
        _assert_equal(got, oracle(tref, idx, val, live, **kw))
        _assert_equal(got, oracle(jref, idx, val, live, **kw))


@pytest.mark.parametrize("parts", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("bypass", [False, True])
def test_one_pass_mark_scan_equals_the_per_partition_passes(parts, bypass):
    """The single-pass scan under seeded tile and look-back schedules gives
    every trigger and filtered lane what one pass a partition gives; with
    the bank bypass every mark counts in partition 0.  Sixteen partitions
    take two passes."""
    stats = {}
    for seed, conc in enumerate((3, 16, 0)):
        rng = np.random.default_rng(100 * parts + seed)
        m = int(rng.integers(6000, 9000))
        kind = rng.choice([KEPT, TRIGGER, FILTERED], m, p=[0.6, 0.1, 0.3])
        part = rng.integers(0, parts, m)
        p_eff = 1 if bypass else parts
        if bypass:
            part[:] = 0
        lanes = np.bincount(part, minlength=p_eff)
        filtered = np.array([((kind == FILTERED) & (part == p)).sum()
                             for p in range(p_eff)])
        tails = 50_000 + np.concatenate([[0], np.cumsum(filtered)[:-1]])
        assert lanes.sum() == m
        got = mark_scan(kind, part, m, p_eff, tails, filtered, rng,
                        threads=32, items=4, conc=conc, stats=stats)
        assert got == mark_passes(kind, part, m, p_eff, tails, filtered)
    assert stats["waits"] > 0 and stats["windows"] > 0


@pytest.mark.parametrize("op,dtype", [("tagged", "float32"),
                                      ("tagged", "int32"),
                                      ("add", "float32"), ("min", "int32"),
                                      ("max", "float32")])
@pytest.mark.parametrize("kind,parts,cap", [
    ("hub", 1, 2), ("hub", 4, 2), ("wide", 4, 1), ("one_partition", 4, 2),
    ("family_set", 2, 3), ("negative", 4, 1), ("wide", 8, 1000)])
def test_round_cap_fallback_matches_both_oracles(op, dtype, kind, parts, cap):
    """Under a round cap the capped partitions (decided after the bypass,
    on live lanes) take the fallback (digit sort, dense scan, the mark
    scan's tail slots, the runs' folds) and the others the chain; the body
    equals both packages' oracles with ``round_cap`` bit for bit.  A hub set
    caps its partition only (hub at 4 partitions: the others walk), the
    bypass caps the one partition (one_partition), indices of both signs
    sort by the flipped sign bit, and a cap no set reaches leaves the hash
    branch alone."""
    num_sets, slots = (64, 8) if kind != "hub" else (16, 4)
    rng = np.random.default_rng(len(kind) * 10 + parts + cap)
    n = 3000
    idx = _stream(kind, n, rng, num_sets)
    val = (rng.uniform(0.0, 1.0, n).astype(np.float32) if dtype == "float32"
           else rng.integers(-1000, 1000, n).astype(np.int32))
    table = _table(idx, rng, kind, num_sets) if op == "tagged" else None
    live = n * 2 // 3 + 1
    kw = dict(num_sets=num_sets, slots=slots, parts=parts, op=op,
              table=table, round_cap=cap)
    stats = {}
    got = model_body(idx, val, live, stats=stats, threads=32, items=4,
                     rng=np.random.default_rng(parts), **kw)
    _assert_equal(got, oracle(tref, idx, val, live, **kw))
    _assert_equal(got, oracle(jref, idx, val, live, **kw))
    if cap < 1000:
        assert stats["capped"] > 0 and stats["longest_run"] > 1
        # non-negative indices below 2^20: the two high digits are skipped
        assert stats.get("skipped", 0) == (0 if kind == "negative" else 2)
    else:
        assert stats["capped"] == 0
    if kind == "hub" and parts == 4:
        assert stats["capped"] < parts
    if kind == "one_partition":
        assert stats.get("bypass")

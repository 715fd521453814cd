"""The single-pass scan of kernel B2, modelled in numpy and held against the
segment-merge oracles.

Kernel B2 (``kernels/segment_merge/segment_merge.cu``) merges a sorted
stream in one launch.  CTAs take tiles from an atomic ticket in reverse
stream order.  A tile runs one forward segmented scan of (last head, value)
pairs -- a serial fold over a thread's lanes, a Kogge-Stone warp scan, a
serial step over the warps -- closes the runs that end inside it, and
publishes one status word: the length of its leading stretch (the lanes of
a run begun in a tile to the left) and the stretch's reduction.  The tile
holding the first lane of a run that crosses its right edge looks back over
the status words of the tiles to its right, a window at a time, polling the
ones not yet published; it folds their stretches in stream order, stops at
the first tile whose stretch ends inside it, and writes the run's total over
the run's lanes there.  op = tagged scans (payload, family) pairs; inactive
lanes and the padding past the stream's end are the empty family that every
combine skips.

``model_merge`` follows those steps at a small geometry (64-lane tiles,
4-thread warps, a 4-tile look-back window), and a seeded scheduler lets the
tiles run interleaved in any order the ticket rule allows, with a seeded cap
on the tiles resident at once.  It checks that each lane's merged value and
survivor flag are written exactly once and that a tile waits only on tiles
that took their ticket before it.  It is held exactly (survivors, min, max,
int32) and to rtol 1e-5 (f32 add, on positive payloads) against the
reference's ``repro.core.filter.merge_sorted`` and the port's plain
``segment_merge_ref`` on the same numpy inputs, and its f32 sums are
bit-identical under every schedule.  The card tests run the kernel itself
(``tests/test_torch_kernels.py``, marked ``gpu``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import filter as jfilt
from repro_torch.kernels.segment_merge.ref import segment_merge_ref
from torch_parity import n as to_np
from torch_parity import sorted_stream, t

THREADS, ITEMS, WARP, WINDOW = 16, 4, 4, 4  # the kernel: 256, 16, 32, 32
TILE = THREADS * ITEMS
MIN_FAM, ADD_FAM, EMPTY = 0, 1, 2


class _Op:
    """The kernel's identity and combine for one op and payload dtype."""

    def __init__(self, op: str, dtype):
        self.op, self.dt = op, np.dtype(dtype)

    def identity(self):
        if self.op == "tagged":
            return (self.dt.type(0), EMPTY)
        if self.op == "add":
            return self.dt.type(0)
        lim = (np.iinfo(self.dt) if self.dt.kind == "i"
               else np.finfo(self.dt))
        big = lim.max if self.dt.kind == "i" else np.inf
        small = lim.min if self.dt.kind == "i" else -np.inf
        return self.dt.type(big if self.op == "min" else small)

    def add(self, a, b):
        if self.dt.kind == "i":  # int32 sums wrap, as torch's do
            return np.int32((int(a) + int(b) + 2**31) % 2**32 - 2**31)
        return self.dt.type(a) + self.dt.type(b)  # rounded to f32

    def combine(self, a, b):
        if self.op == "tagged":
            (av, af), (bv, bf) = a, b
            if bf == EMPTY:
                return a
            if af == EMPTY:
                return b
            return (self.add(av, bv) if bf == ADD_FAM
                    else (bv if bv < av else av), bf)
        if self.op == "add":
            return self.add(a, b)
        if self.op == "min":
            return b if b < a else a
        return b if b > a else a

    @staticmethod
    def payload(v):
        return v[0] if isinstance(v, tuple) else v


class _Run:
    """One call's shared state: inputs, status words, outputs, counters."""

    def __init__(self, idx, vals, op, active, tags):
        self.idx, self.vals, self.n = idx, vals, idx.shape[0]
        self.act = (np.ones(self.n, bool) if active is None
                    else active.astype(bool))
        self.tags = tags
        self.ops = _Op(op, vals.dtype)
        self.tiles = -(-self.n // TILE)
        self.status: list = [None] * self.tiles  # (stretch length, value)
        self.ticket_of: dict[int, int] = {}
        self.merged = vals.copy()
        self.merged_writes = np.zeros(self.n, int)
        self.surv = np.zeros(self.n, bool)
        self.surv_writes = np.zeros(self.n, int)
        self.stats = {"polls": 0, "early_close": 0, "full_windows": 0,
                      "crossing_runs": 0}

    def cont(self, p: int) -> bool:
        """Lane p continues its predecessor's run."""
        return (0 < p < self.n and bool(self.act[p])
                and self.idx[p] == self.idx[p - 1])

    def x(self, p: int):
        """Lane p's scan input: the empty value or identity when inactive."""
        if not self.act[p]:
            return self.ops.identity()
        if self.ops.op == "tagged":
            return (self.vals[p], ADD_FAM if self.tags[p] else MIN_FAM)
        return self.vals[p]

    def write(self, p: int, value) -> None:
        self.merged[p] = value
        self.merged_writes[p] += 1


def _tile(r: _Run, t_: int):
    """One CTA on tile ``t_``; yields where the kernel may be overtaken."""
    yield  # the ticket is taken; the loads and the scan come later
    ops = r.ops
    L = t_ * TILE
    ln = min(TILE, r.n - L)
    R = L + ln
    head = [not r.cont(L + i) for i in range(ln)]
    # thread fold
    inc = []
    for th in range(THREADS):
        s, v = -1, ops.identity()
        for i in range(th * ITEMS, (th + 1) * ITEMS):
            if i < ln and head[i]:
                s, v = i, r.x(L + i)
            else:
                v = ops.combine(v, r.x(L + i) if i < ln else ops.identity())
        inc.append((s, v))
    # warp scan: each step reads the values of the step before (shuffles)
    for w0 in range(0, THREADS, WARP):
        d = 1
        while d < WARP:
            before = inc[w0:w0 + WARP]
            for lane in range(d, WARP):
                (so, vo), (s, v) = before[lane - d], before[lane]
                inc[w0 + lane] = (max(s, so), v if s >= 0
                                  else ops.combine(vo, v))
            d *= 2
    start = [0] * ln
    tot: dict[int, object] = {}
    cross, trail = -1, None
    for th in range(THREADS):
        lane, w0 = th % WARP, th - th % WARP
        cs, cv = -1, ops.identity()  # the warps before, serially
        for wt in range(WARP - 1, w0, WARP):
            ts, tv = inc[wt]
            cs, cv = (ts, tv) if ts >= 0 else (cs, ops.combine(cv, tv))
        es, ev = inc[th - 1] if lane else (-1, ops.identity())
        cs, cv = (es, ev) if es >= 0 else (cs, ops.combine(cv, ev))
        for i in range(th * ITEMS, min((th + 1) * ITEMS, ln)):  # rescan
            if head[i]:
                cs, cv = i, r.x(L + i)
            else:
                cv = ops.combine(cv, r.x(L + i))
            start[i] = cs
            cont_next = r.cont(L + i + 1)
            if cs < 0 and (i == ln - 1 or not cont_next):
                assert r.status[t_] is None
                r.status[t_] = (i + 1, cv)  # the leading stretch ends here
            if cs >= 0 and not cont_next:
                tot[cs] = ops.payload(cv)  # a run closes here
            elif cs >= 0 and i == ln - 1:
                cross, trail = cs, cv  # the run crosses the right edge
    if head[0]:
        assert r.status[t_] is None
        r.status[t_] = (0, ops.identity())
    yield
    if cross >= 0:  # the head tile's look-back over the tiles to its right
        r.stats["crossing_runs"] += 1
        total, base, end = trail, t_ + 1, None
        while end is None:
            us = range(base, base + WINDOW)
            words = [None] * WINDOW
            while True:
                for j, u in enumerate(us):
                    if words[j] is None and u >= r.tiles:
                        words[j] = "out of range"
                    elif words[j] is None and r.status[u] is not None:
                        assert r.ticket_of[u] < r.ticket_of[t_]
                        words[j] = r.status[u]
                ready = [w is not None for w in words]
                closes = [isinstance(w, tuple) and (
                    w[0] < min(TILE, r.n - u * TILE) or u == r.tiles - 1)
                    for w, u in zip(words, us)]
                first_unready = (ready + [False]).index(False)
                first_close = (closes + [True]).index(True)
                if first_close < first_unready or first_unready == WINDOW:
                    break
                r.stats["polls"] += 1
                yield
            closed = first_close < first_unready
            r.stats["early_close"] += closed and first_unready < WINDOW
            r.stats["full_windows"] += not closed
            for j in range(first_close + 1 if closed else WINDOW):
                length, v = words[j]
                if length > 0:  # stream order: the same fold every call
                    total = ops.combine(total, v)
                if closed and j == first_close:
                    end = (base + j) * TILE + length
            base += WINDOW
        tot[cross] = ops.payload(total)
        yield
    for i in range(ln):  # the tile's lanes, less its leading stretch
        p = L + i
        if start[i] >= 0:
            r.write(p, tot[start[i]] if r.act[p] else r.vals[p])
        r.surv[p] = r.act[p] and head[i]
        r.surv_writes[p] += 1
    if cross >= 0:
        for q in range(R, end):
            r.write(q, tot[cross])


def model_merge(idx, vals, op="add", active=None, tags=None, *, seed=0,
                resident=None):
    """``(merged, survivors, stats)`` of the modelled kernel.  Tiles start
    in ticket order (reverse stream order), at most ``resident`` at a time,
    and a seeded scheduler interleaves their steps."""
    r = _Run(idx, vals, op, active, tags)
    rng = np.random.default_rng(seed)
    cap = resident or r.tiles
    running, ticket = [], 0
    for _ in range(10_000 * r.tiles):  # a status never published hangs
        if not (running or ticket < r.tiles):
            break
        can_start = ticket < r.tiles and len(running) < cap
        pick = int(rng.integers(len(running) + can_start))
        if pick == len(running):
            tile = r.tiles - 1 - ticket
            r.ticket_of[tile] = ticket
            running.append(_tile(r, tile))
            ticket += 1
        try:
            next(running[pick])
        except StopIteration:
            running.pop(pick)
    else:
        raise AssertionError("the tiles deadlocked")
    assert (r.surv_writes == 1).all() and (r.merged_writes == 1).all()
    return r.merged, r.surv, r.stats


def _stream(case: str, rng) -> np.ndarray:
    if case == "runs_cross_tiles":  # ~120-lane runs over 64-lane tiles
        return sorted_stream(700, 6, rng)
    if case == "one_run_every_tile":
        return np.full(9 * TILE + 5, 42, np.int32)
    if case == "hub":  # one 400-lane hub among short runs
        return sorted_stream(1000, 150, rng, long_run=400)
    length = {"tile_minus_1": TILE - 1, "tile": TILE,
              "tile_plus_1": TILE + 1}[case]
    return sorted_stream(length, 16, rng)


def _values(op: str, dtype: str, length: int, rng) -> np.ndarray:
    if dtype == "int32":
        return rng.integers(-1000, 1000, length).astype(np.int32)
    if op in ("add", "tagged"):  # positive, as PageRank's contributions
        return rng.uniform(0.5, 2.0, length).astype(np.float32)
    return rng.standard_normal(length).astype(np.float32)


def _oracles(idx, vals, op, active, tags):
    """The reference's merge_sorted and the port's plain version."""
    jact = None if active is None else jnp.asarray(active)
    jtags = None if tags is None else jnp.asarray(tags)
    want = jfilt.merge_sorted(jnp.asarray(idx), jnp.asarray(vals), op,
                              active=jact, tags=jtags)
    plain = segment_merge_ref(t(idx), t(vals), op,
                              None if active is None else t(active),
                              None if tags is None else t(tags))
    return ((np.asarray(want[0]), np.asarray(want[1])),
            (to_np(plain[0]), to_np(plain[1])))


def _assert_matches(got, want, op, dtype):
    assert np.array_equal(got[1], want[1])  # survivors
    if dtype == "float32" and op in ("add", "tagged"):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=0)
    else:
        assert np.array_equal(got[0], want[0])


CASES = ["runs_cross_tiles", "one_run_every_tile", "hub", "tile_minus_1",
         "tile", "tile_plus_1"]


@pytest.mark.parametrize("op", ["add", "min", "max", "tagged"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("live", [None, "empty", "half", "full"])
def test_model_matches_oracles(op, dtype, case, live):
    rng = np.random.default_rng(CASES.index(case))
    idx = _stream(case, rng)
    length = idx.shape[0]
    vals = _values(op, dtype, length, rng)
    active = None if live is None else np.arange(length) < {
        "empty": 0, "half": length // 2, "full": length}[live]
    tags = None
    if op == "tagged":  # a per-index family table: every run uniform-tag
        tags = (rng.random(int(idx.max()) + 1) < 0.5)[idx]
    got = model_merge(idx, vals, op, active, tags, seed=length,
                      resident=1 + length % 5)
    for want in _oracles(idx, vals, op, active, tags):
        _assert_matches(got, want, op, dtype)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("live", [1, 300, 699])
def test_model_tagged_dead_tail_of_the_other_family(dtype, live):
    """The sort engine's dead tail: unsorted real indices, each with its own
    index's family, here always the other family than the last live run's
    (an inert payload chosen by a dead lane's tag would poison the run)."""
    rng = np.random.default_rng(live)
    length = 700
    table = rng.random(64) < 0.5
    idx = np.sort(rng.integers(0, 64, length)).astype(np.int32)
    other = np.flatnonzero(table != table[idx[live - 1]])
    idx[live:] = rng.choice(other, length - live)
    vals = _values("tagged", dtype, length, rng)
    active = np.arange(length) < live
    got = model_merge(idx, vals, "tagged", active, table[idx], seed=live,
                      resident=3)
    for want in _oracles(idx, vals, "tagged", active, table[idx]):
        _assert_matches(got, want, "tagged", dtype)


@pytest.mark.parametrize("op", ["add", "tagged"])
def test_model_f32_sums_are_the_same_under_every_schedule(op):
    """The look-back folds in stream order and keeps no inclusive prefix,
    so a run's total does not depend on which tiles had published: every
    interleaving gives the same bits."""
    rng = np.random.default_rng(3)
    idx = sorted_stream(1200, 40, rng, long_run=500)
    vals = _values(op, "float32", idx.shape[0], rng)
    tags = (rng.random(int(idx.max()) + 1) < 0.5)[idx]
    tags = tags if op == "tagged" else None
    runs = [model_merge(idx, vals, op, None, tags, seed=s, resident=cap)
            for s, cap in ((0, 1), (1, 2), (2, 7), (3, None), (4, None))]
    for merged, surv, _ in runs[1:]:
        assert np.array_equal(merged, runs[0][0])
        assert np.array_equal(surv, runs[0][1])


def test_model_takes_every_look_back_path():
    """Across schedules the look-back polls unpublished tiles, closes early
    with later tiles of its window still unpublished, and reads whole
    windows of tiles that the run covers before it closes."""
    rng = np.random.default_rng(5)
    idx = sorted_stream(3000, 12, rng, long_run=900)
    vals = _values("add", "float32", idx.shape[0], rng)
    total = {"polls": 0, "early_close": 0, "full_windows": 0,
             "crossing_runs": 0}
    for seed in range(4):
        _, _, stats = model_merge(idx, vals, "add", seed=seed, resident=6)
        for k, v in stats.items():
            total[k] += v
    assert all(v > 0 for v in total.values()), total

"""The batched walk of kernel B3, modelled in numpy and held against the
IRU hash oracles.

Kernel B3 (``kernels/iru_reorder/iru_reorder.cu``) walks each hash set with
one warp, lane j holding slot j, and advances over a batch of 32 arrivals a
step.  A batch is cut into sub-steps at triggers: in a sub-step that starts
at lane ``a`` with ``cnt`` residents, an arrival is filtered if its index
equals a resident's or an earlier arrival's of the sub-step; the others are
new and take slots ``cnt, cnt+1, ...`` in lane order; the new arrival that
takes slot ``slots-1`` is the trigger and ends the sub-step, and the next
sub-step starts after it with an empty set.  Each slot's owner folds its
sub-step's filtered arrivals in lane order.

``batched_walk`` below follows those steps with the kernel's masks, so it
pins the sub-step logic on the CPU; the card tests run the kernel itself
(``tests/test_torch_kernels.py``, marked ``gpu``).  It is held exactly --
payloads included, since both fold in stream order -- against the port's
element-sequential oracle ``repro_torch.kernels.iru_reorder.ref`` and the
reference's ``repro.kernels.iru_reorder.ref`` on the same numpy inputs.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.kernels.iru_reorder import ref as jref
from repro_torch.kernels.iru_reorder import ref as tref

WARP = 32
EPB = 32  # block_bytes // elem_bytes at the defaults (128 // 4)
_FOLD = {"add": lambda a, b: a + b, "min": min, "max": max}


def _fold(op, a, b, index):
    """One filtered arrival ``b`` folded into the survivor ``a`` of
    ``index``: by the op, or, when ``op`` is a bool tag table (the tagged
    fold), by the index's family (True = add, else min)."""
    if isinstance(op, str):
        return _FOLD[op](a, b)
    return _FOLD["add" if op[min(max(int(index), 0), op.size - 1)]
                 else "min"](a, b)


def _walk_set(idx, val, pos, slots, op, stats):
    """Walk one set's arrivals (stream order); returns (flush groups with
    their trigger positions, the drain group, filtered positions)."""
    flushes, filtered = [], []
    res: list[list] = []  # slot j: [index, payload, position]
    for k0 in range(0, len(idx), WARP):
        ei, ev, ep = idx[k0:k0 + WARP], val[k0:k0 + WARP], pos[k0:k0 + WARP]
        steps, a = len(ei), 0
        while a < steps:
            sub = range(a, steps)
            owner_of = {}  # arrival lane -> resident slot it hits
            if op is not None:
                for j, r in enumerate(res):
                    owner_of.update({t: j for t in sub if ei[t] == r[0]})
                new = [t for t in sub if t not in owner_of
                       and all(ei[u] != ei[t] for u in range(a, t))]
            else:
                new = list(sub)
            need = slots - len(res)
            trig = len(new) >= need
            last = new[need - 1] if trig else steps - 1
            ins = [t for t in new if t <= last]
            base = len(res)
            res += [[ei[t], ev[t], ep[t]] for t in ins]
            if op is not None:
                for t in range(a, last + 1):  # lane order = stream order
                    if t in ins:
                        continue
                    j = owner_of.get(t)
                    if j is None:  # an earlier arrival of this sub-step
                        j = base + next(i for i, u in enumerate(ins)
                                        if ei[u] == ei[t])
                    res[j][1] = _fold(op, res[j][1], ev[t], res[j][0])
                    filtered.append(ep[t])
            if trig:
                stats["trigger_lanes"].add(last)
                stats["sub_steps_after_trigger"] += last + 1 < steps
                flushes.append((ep[last], res))
                res = []
            a = last + 1
    return flushes, res, filtered


def batched_walk(indices, secondary, *, num_sets, slots, filter_op,
                 stats=None):
    """The kernel's buffer layout from the batched walk of every set."""
    stats = {"trigger_lanes": set(), "sub_steps_after_trigger": 0} \
        if stats is None else stats
    indices = np.asarray(indices, np.int32)
    secondary = np.asarray(secondary)
    n = indices.shape[0]
    sets = tref.hash_set(indices // np.int32(EPB), num_sets)
    order = np.argsort(sets, kind="stable")
    flushes, drains, filtered = [], [], []
    for s in range(num_sets):
        p = order[sets[order] == s]
        f, d, x = _walk_set(indices[p], secondary[p], p, slots, filter_op,
                            stats)
        flushes += f
        drains += d
        filtered += x
    entries = [e for _, grp in sorted(flushes, key=lambda f: f[0])
               for e in grp] + drains
    out_idx = np.zeros(n, np.int32)
    out_sec = np.zeros(n, secondary.dtype)
    out_pos = np.zeros(n, np.int32)
    out_act = np.zeros(n, bool)
    for o, (i, v, p) in enumerate(entries):
        out_idx[o], out_sec[o], out_pos[o], out_act[o] = i, v, p, True
    for k, p in enumerate(sorted(filtered)):  # reverse detection order
        out_idx[n - 1 - k], out_sec[n - 1 - k], out_pos[n - 1 - k] = (
            indices[p], secondary[p], p)
    return out_idx, out_sec, out_pos, out_act


def _stream(kind: str, length: int, rng) -> np.ndarray:
    if kind == "hot":     # 40 indices in two blocks: long duplicate runs
        return rng.integers(0, 40, length).astype(np.int32)
    if kind == "padded":  # a padded expansion's sentinel lanes mixed in
        idx = rng.integers(0, 5000, length)
        idx[rng.random(length) < 0.3] = 5000
        return idx.astype(np.int32)
    return rng.integers(0, 50_000, length).astype(np.int32)  # wide


def _payload(dtype: str, length: int, rng) -> np.ndarray:
    if dtype == "int32":
        return rng.integers(-1000, 1000, length).astype(np.int32)
    return rng.uniform(0.0, 1.0, length).astype(np.float32)


def _assert_equal(got, want):
    for field, a, b in zip(("indices", "payload", "positions", "active"),
                           got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), field


# the geometries of the card tests' HASH_CASES
GEOMETRIES = [(1024, 32), (8192, 32), (16, 4), (8, 2)]


@pytest.mark.parametrize("op", [None, "add", "min", "max"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("kind,dtype", [("wide", "float32"),
                                        ("hot", "float32"),
                                        ("padded", "int32")])
def test_batched_walk_matches_both_oracles(op, geometry, kind, dtype):
    num_sets, slots = geometry
    rng = np.random.default_rng(num_sets + slots)
    idx = _stream(kind, 1200, rng)
    vals = _payload(dtype, 1200, rng)
    kw = dict(num_sets=num_sets, slots=slots, filter_op=op)
    got = batched_walk(idx, vals, **kw)
    _assert_equal(got, tref.hash_reorder_ref(idx, vals, **kw))
    _assert_equal(got, jref.hash_reorder_ref(idx, vals, **kw))


@pytest.mark.parametrize("op", [None, "add", "min", "max"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_batched_walk_with_a_live_prefix(op, geometry):
    num_sets, slots = geometry
    rng = np.random.default_rng(7)
    idx = _stream("hot", 900, rng)
    vals = _payload("float32", 900, rng)
    kw = dict(num_sets=num_sets, slots=slots, filter_op=op)
    for m in (0, 600, 900):
        got = tref.ragged_oracle(batched_walk, idx, vals, m, **kw)
        _assert_equal(got, jref.ragged_oracle(jref.hash_reorder_ref, idx,
                                              vals, m, **kw))


@pytest.mark.parametrize("slots", [2, 4, 32])
def test_triggers_on_the_first_and_last_lane_of_a_batch(slots):
    # one set (block 2 of 32 indices).  Batch 0 holds 32 distinct indices,
    # so a trigger falls on lane 31; batch 1 ends in a duplicate, so the
    # set lacks one index at its end, and batch 2 opens with that index: a
    # trigger on lane 0
    base = np.arange(64, 96, dtype=np.int32)
    idx = np.concatenate([base, base[:31], base[30:31], np.roll(base, -31)])
    vals = np.arange(idx.size, dtype=np.float32) / 7
    stats = {"trigger_lanes": set(), "sub_steps_after_trigger": 0}
    got = batched_walk(idx, vals, num_sets=8, slots=slots, filter_op="add",
                       stats=stats)
    _assert_equal(got, tref.hash_reorder_ref(idx, vals, num_sets=8,
                                             slots=slots, filter_op="add"))
    assert {0, 31} <= stats["trigger_lanes"]


def test_resident_reappears_after_a_trigger_in_the_same_batch():
    # slots 4: a b c d flushes at lane 3; the a at lane 4 is a new insert of
    # the next round, not a duplicate of the flushed a
    idx = np.array([64, 65, 66, 67, 64, 65, 64, 70], np.int32)
    vals = np.arange(1, 9, dtype=np.float32)
    stats = {"trigger_lanes": set(), "sub_steps_after_trigger": 0}
    got = batched_walk(idx, vals, num_sets=8, slots=4, filter_op="add",
                       stats=stats)
    want = tref.hash_reorder_ref(idx, vals, num_sets=8, slots=4,
                                 filter_op="add")
    _assert_equal(got, want)
    assert stats["trigger_lanes"] == {3} and stats["sub_steps_after_trigger"]
    assert list(got[0][:4]) == [64, 65, 66, 67] and got[3][4]  # 64 re-kept
    assert not got[3][-1] and got[2][-1] == 6  # the second 64 of round 2


def test_single_set_stream_over_many_batches():
    rng = np.random.default_rng(3)
    idx = (rng.integers(0, 32, 20_000) + 64).astype(np.int32)  # one block
    vals = rng.uniform(0.0, 1.0, 20_000).astype(np.float32)
    for op in ("add", None):
        kw = dict(num_sets=1024, slots=32, filter_op=op)
        _assert_equal(batched_walk(idx, vals, **kw),
                      tref.hash_reorder_ref_vec(idx, vals, **kw))

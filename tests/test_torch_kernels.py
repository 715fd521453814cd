"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a card (a CUDA kernel has
no CPU mode).  The file imports neither ``jax`` nor ``repro``, so it also
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py

Tolerances: the gather is exact; segment-merge survivor masks and ``min`` /
``max`` payloads are exact; float ``add`` payloads are held to rtol 1e-5
(+ atol 1e-6 near zero), because the kernel's scans add in another order than
the plain scatter reduction.  The IRU hash (B3) gives indices, positions,
active flags and min/max payloads exactly; its float ``add`` folds run in
stream order, as in the numpy oracle, so they equal the oracle exactly and
the plain version (whose scatter adds in another order) within rtol 1e-5.
Its float payloads are positive, as PageRank's are: long mixed-sign sums
cancel, and two f32 orders of one such sum can differ by more than any
relative tolerance of the result (3.3e-5 on one lane of 65,536 in a first
run on the card), while the exact check against the oracle holds either way.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import filter as filt
from repro_torch.kernels import launch_counts
from repro_torch.kernels.coalesced_gather import ops as gather_ops
from repro_torch.kernels.coalesced_gather.ref import coalesced_gather_ref
from repro_torch.kernels.iru_reorder import ops as hash_ops
from repro_torch.kernels.iru_reorder import ref as hash_ref
from repro_torch.kernels.segment_merge import ops as merge_ops
from repro_torch.kernels.segment_merge.ref import segment_merge_ref
from repro_torch.graphs.generators import kron_edges
from torch_parity import cuda  # noqa: F401  (a fixture)
from torch_parity import offsets_stream as _stream
from torch_parity import sorted_stream as _sorted_stream
from torch_parity import t

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("group,window", [(8, 128), (256, 256), (3, 5),
                                          (5000, 64)])
@pytest.mark.parametrize("v", [7, 200, 70_000])
@pytest.mark.parametrize("kind", ["monotone", "runs", "shuffled", "strided",
                                  "sparse"])
@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("length", [9999, 4095, 4096, 4097])
def test_gather_matches_plain(cuda, group, window, v, kind, d, length):
    # 4096 lanes is the kernel's tile at group 8 (1536 at group 3, one
    # group at 5000); strided offsets at v = 70,000 make a tile's
    # contract-meeting groups span more rows than it can stage
    rng = np.random.default_rng(v + group)
    table = t(rng.standard_normal((v, d)).astype(np.float32), cuda)
    idx = t(_stream(kind, v, length, rng), cuda)
    before = launch_counts["coalesced_gather"]
    got = gather_ops.coalesced_gather(table, idx, group=group, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, coalesced_gather_ref(table, idx))
    assert launch_counts["coalesced_gather"] == before + 1


def test_csr_edge_gather_matches_plain(cuda):
    rng = np.random.default_rng(4)
    col = t(rng.integers(0, 10**6, 300_000).astype(np.int32), cuda)
    w = t(rng.uniform(1, 64, 300_000).astype(np.float32), cuda)
    off = t(_stream("monotone", 300_000, 123_457, rng), cuda)
    dsts, wts = gather_ops.csr_edge_gather(col, off, w)
    assert torch.equal(dsts, col[off.long()])
    assert torch.equal(wts, w[off.long()])
    assert torch.equal(gather_ops.csr_edge_gather(col, off), col[off.long()])


def test_gather_rejects_bad_inputs(cuda):
    table = torch.zeros(10, 3, device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        gather_ops.coalesced_gather(table, idx)          # D = 3
    with pytest.raises(ValueError):
        gather_ops.coalesced_gather(table[:, :1].contiguous(), idx.long())
    with pytest.raises(ValueError):
        gather_ops.coalesced_gather(table[:, :1].cpu(), idx)


# B2's tile is 4096 lanes: its edges, and a hub run over 110 tiles
MERGE_LENGTHS = [(1, 0), (1023, 0), (1025, 0), (4095, 0), (4096, 0),
                 (4097, 0), (70_000, 5000), (300_000, 150_000),
                 (500_000, 450_000)]


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("length,long_run", MERGE_LENGTHS)
@pytest.mark.parametrize("live", [None, 0, "half", "all"])
def test_segment_merge_matches_plain(cuda, op, dtype, length, long_run, live):
    rng = np.random.default_rng(length)
    idx = t(_sorted_stream(length, max(length // 8, 2), rng, long_run), cuda)
    if dtype == "int32":
        vals = t(rng.integers(-1000, 1000, length).astype(np.int32), cuda)
    else:
        vals = t(rng.standard_normal(length).astype(np.float32), cuda)
    active = None if live is None else torch.arange(
        length, device=cuda) < {0: 0, "half": length // 2,
                                "all": length}[live]
    got_v, got_s = merge_ops.segment_merge(idx, vals, op=op, active=active)
    want_v, want_s = segment_merge_ref(idx, vals, op, active)
    torch.cuda.synchronize()
    assert torch.equal(got_s, want_s)
    if op == "add" and dtype == "float32":
        torch.testing.assert_close(got_v, want_v, rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(got_v, want_v)


def test_segment_merge_rejects_bad_inputs(cuda):
    idx = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        merge_ops.segment_merge(idx, torch.zeros(8, 2, device=cuda))
    with pytest.raises(ValueError):
        merge_ops.segment_merge(idx.long(), torch.zeros(8, device=cuda))
    with pytest.raises(ValueError):
        merge_ops.segment_merge(idx, torch.zeros(8, device=cuda,
                                                 dtype=torch.float64))
    with pytest.raises(ValueError):  # tags are bool lanes
        merge_ops.segment_merge(idx, torch.zeros(8, device=cuda), op="tagged",
                                tags=torch.zeros(8, dtype=torch.int32,
                                                 device=cuda))
    with pytest.raises(ValueError):  # tagged needs its tags
        filt.merge_sorted(idx, torch.zeros(8, device=cuda), "tagged")


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("length,long_run", MERGE_LENGTHS)
@pytest.mark.parametrize("live", [None, 0, "half", "all"])
def test_segment_merge_tagged_matches_plain(cuda, dtype, length, long_run,
                                            live):
    """B2's tagged body: each run folds under its index's family.  The
    dead tail's lanes carry their own indices' tags, so some of them name
    the other family than the last live run (an inert payload chosen by a
    dead lane's tag would poison an add run with +inf)."""
    rng = np.random.default_rng(length + 1)
    idx_np = _sorted_stream(length, max(length // 8, 2), rng, long_run)
    table = rng.random(int(idx_np.max()) + 2) < 0.5
    if long_run:  # the hub run (crossing tiles) in the add family
        table[idx_np[0] if length == 1 else np.bincount(idx_np).argmax()] = 1
    idx, tags = t(idx_np, cuda), t(table[idx_np], cuda)
    if dtype == "int32":
        vals = t(rng.integers(-1000, 1000, length).astype(np.int32), cuda)
    else:
        vals = t(rng.standard_normal(length).astype(np.float32), cuda)
    active = None if live is None else torch.arange(
        length, device=cuda) < {0: 0, "half": length // 2,
                                "all": length}[live]
    before = dict(launch_counts)
    got_v, got_s = merge_ops.segment_merge(idx, vals, op="tagged",
                                           active=active, tags=tags)
    torch.cuda.synchronize()
    assert launch_counts["segment_merge_tagged"] == before.get(
        "segment_merge_tagged", 0) + 1
    assert launch_counts["segment_merge"] == before.get("segment_merge", 0)
    want_v, want_s = segment_merge_ref(idx, vals, "tagged", active, tags)
    assert torch.equal(got_s, want_s)
    assert torch.equal(got_v[~tags], want_v[~tags])  # the min family
    if dtype == "int32":
        assert torch.equal(got_v[tags], want_v[tags])
    else:
        torch.testing.assert_close(got_v[tags], want_v[tags], rtol=1e-5,
                                   atol=1e-6)
    # and through core.filter, as the sort engine calls it
    via = filt.merge_sorted(idx, vals, "tagged", active, tags)
    assert torch.equal(via[0], got_v) and torch.equal(via[1], got_s)


@pytest.mark.parametrize("op", ["add", "tagged"])
@pytest.mark.parametrize("live", [None, "part"])
def test_segment_merge_repeated_calls_are_bit_identical(cuda, op, live):
    """The look-back folds the tiles of a run in stream order, so f32 sums
    do not depend on the order in which tiles ran."""
    rng = np.random.default_rng(11)
    length = 2_000_000
    idx_np = _sorted_stream(length, 60_000, rng, long_run=400_000)
    idx = t(idx_np, cuda)
    vals = t(rng.uniform(0.0, 1.0, length).astype(np.float32), cuda)
    tags = (t((rng.random(int(idx_np.max()) + 1) < 0.5)[idx_np], cuda)
            if op == "tagged" else None)
    active = None if live is None else torch.arange(
        length, device=cuda) < length * 7 // 10
    first = merge_ops.segment_merge(idx, vals, op=op, active=active,
                                    tags=tags)
    for _ in range(3):
        again = merge_ops.segment_merge(idx, vals, op=op, active=active,
                                        tags=tags)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])


@pytest.mark.parametrize("op", ["add", "min", "tagged"])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_segment_merge_unaligned_views_match_plain(cuda, op, offset):
    """Views that start off a 16-byte boundary take the scalar loads."""
    rng = np.random.default_rng(offset)
    length = 50_000 + offset
    idx_np = _sorted_stream(length, 3000, rng, long_run=9000)
    idx = t(idx_np, cuda)[offset:]
    vals = t(rng.standard_normal(length).astype(np.float32), cuda)[offset:]
    active = (torch.arange(length, device=cuda) < length // 2)[offset:]
    tags = (t((rng.random(int(idx_np.max()) + 1) < 0.5)[idx_np],
              cuda)[offset:] if op == "tagged" else None)
    got_v, got_s = merge_ops.segment_merge(idx, vals, op=op, active=active,
                                           tags=tags)
    want_v, want_s = segment_merge_ref(idx, vals, op, active, tags)
    torch.cuda.synchronize()
    assert torch.equal(got_s, want_s)
    if op == "min":
        assert torch.equal(got_v, want_v)
    else:
        torch.testing.assert_close(got_v, want_v, rtol=1e-5, atol=1e-6)


def _hash_stream(kind: str, length: int, rng) -> np.ndarray:
    if kind == "hot":      # few indices: long duplicate runs, many rounds
        return rng.integers(0, 40, length).astype(np.int32)
    if kind == "padded":   # a padded expansion: sentinel index lanes mixed in
        idx = rng.integers(0, 5000, length)
        idx[rng.random(length) < 0.3] = 5000
        return idx.astype(np.int32)
    if kind == "kron":     # an R-MAT edge list's destinations (hubs)
        _, dst, _ = kron_edges(scale=12, edge_factor=16)
        return dst[:length].astype(np.int32)
    base = np.arange(64, 96, dtype=np.int32)  # block 2: a single set
    if kind == "lanes":    # 32 distinct (a trigger on lane 31), 31 and a
        # duplicate, then the missing index first (a trigger on lane 0)
        return np.resize(np.concatenate([base, base[:31], base[30:31],
                                         np.roll(base, -31)]), length)
    if kind == "reappear":  # at slots 4, 64 comes back right after a flush
        return np.resize(np.array([64, 65, 66, 67, 64, 65, 64, 70],
                                  np.int32), length)
    if kind == "one_set":
        return (rng.integers(0, 32, length) + 64).astype(np.int32)
    return rng.integers(0, 50_000, length).astype(np.int32)


HASH_CASES = [((1024, 32), "wide", 1), ((1024, 32), "wide", 3000),
              ((1024, 32), "hot", 3000), ((1024, 32), "padded", 20_000),
              ((1024, 32), "wide", 200_000), ((1024, 32), "kron", 65_536),
              ((8192, 32), "wide", 20_000),  # 128 KB of binning counters
              ((16, 4), "wide", 3000), ((16, 4), "hot", 3000),
              ((8, 2), "hot", 2000), ((8, 2), "padded", 5000),
              # the walk's batches: triggers on lanes 0 and 31, a flushed
              # resident back in the same batch, one set of 1.5e5 arrivals
              ((8, 2), "lanes", 3000), ((8, 4), "lanes", 3000),
              ((8, 32), "lanes", 3000), ((8, 4), "reappear", 3000),
              ((1024, 32), "one_set", 150_000)]


@pytest.mark.parametrize("op", [None, "add", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("geometry,kind,length", HASH_CASES)
@pytest.mark.parametrize("live", [None, 0, "part", "all"])
def test_hash_reorder_matches_plain_and_oracle(cuda, op, dtype, geometry,
                                               kind, length, live):
    num_sets, slots = geometry
    rng = np.random.default_rng(length + num_sets)
    idx = _hash_stream(kind, length, rng)
    if dtype == "int32":
        vals = rng.integers(-1000, 1000, length).astype(np.int32)
    else:  # positive, like PageRank's contributions (see the docstring)
        vals = rng.uniform(0.0, 1.0, length).astype(np.float32)
    m = {None: length, 0: 0, "part": length * 2 // 3, "all": length}[live]
    n_live = (None if live is None
              else torch.tensor(m, dtype=torch.int32, device=cuda))
    kw = dict(num_sets=num_sets, slots=slots, filter_op=op, n_live=n_live)
    before = launch_counts["iru_reorder"]
    got = hash_ops.hash_reorder(t(idx, cuda), t(vals, cuda), **kw)
    torch.cuda.synchronize()
    assert launch_counts["iru_reorder"] == before + 1
    plain = hash_ops.hash_reorder(t(idx, cuda), t(vals, cuda), kernels=False,
                                  **kw)
    assert launch_counts["iru_reorder"] == before + 1
    oracle = hash_ref.ragged_oracle(hash_ref.hash_reorder_ref_vec, idx, vals,
                                    m, num_sets=num_sets, slots=slots,
                                    filter_op=op)
    for field, want in zip(("indices", "positions", "active"),
                           (oracle[0], oracle[2], oracle[3])):
        g = getattr(got, field)
        assert torch.equal(g, getattr(plain, field)), field
        assert np.array_equal(g.cpu().numpy(), want), field
    # the kernel folds in stream order, like the oracle
    assert np.array_equal(got.secondary.cpu().numpy(), oracle[1])
    if op == "add" and dtype == "float32":
        torch.testing.assert_close(got.secondary, plain.secondary, rtol=1e-5,
                                   atol=1e-6)
    else:
        assert torch.equal(got.secondary, plain.secondary)


TAGGED_CASES = [((1024, 32), "wide", 3000), ((1024, 32), "hot", 3000),
                ((1024, 32), "padded", 20_000), ((1024, 32), "kron", 65_536),
                ((16, 4), "hot", 3000), ((8, 2), "lanes", 3000),
                ((8, 4), "reappear", 3000), ((1024, 32), "one_set", 150_000)]


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("geometry,kind,length", TAGGED_CASES)
@pytest.mark.parametrize("live", [None, 0, "part"])
def test_hash_reorder_tagged_matches_plain_and_oracle(cuda, dtype, geometry,
                                                      kind, length, live):
    """B3's tagged fold: each slot folds under its index's family.  The
    layout is the single-op layout (filtering depends on index equality
    alone), so the kernel equals the numpy oracle run with ``add`` on the
    add family's lanes and with ``min`` on the min family's, bit for bit."""
    num_sets, slots = geometry
    rng = np.random.default_rng(length + num_sets + 7)
    idx = _hash_stream(kind, length, rng)
    table = rng.random(int(idx.max()) + 2) < 0.5
    if dtype == "int32":
        vals = rng.integers(-1000, 1000, length).astype(np.int32)
    else:  # positive, like PPR's contributions (see the docstring)
        vals = rng.uniform(0.0, 1.0, length).astype(np.float32)
    m = {None: length, 0: 0, "part": length * 2 // 3}[live]
    n_live = (None if live is None
              else torch.tensor(m, dtype=torch.int32, device=cuda))
    kw = dict(num_sets=num_sets, slots=slots, filter_op="tagged",
              n_live=n_live, tag_table=t(table, cuda))
    before = dict(launch_counts)
    got = hash_ops.hash_reorder(t(idx, cuda), t(vals, cuda), **kw)
    torch.cuda.synchronize()
    assert launch_counts["iru_reorder_tagged"] == before.get(
        "iru_reorder_tagged", 0) + 1
    assert launch_counts["iru_reorder"] == before.get("iru_reorder", 0)
    plain = hash_ops.hash_reorder(t(idx, cuda), t(vals, cuda), kernels=False,
                                  **kw)
    oracle = {op: hash_ref.ragged_oracle(
        hash_ref.hash_reorder_ref_flat, idx, vals, m, num_sets=num_sets,
        slots=slots, filter_op=op) for op in ("add", "min")}
    for k, field in enumerate(("indices", "secondary", "positions",
                               "active")):
        if field == "secondary":
            continue
        g = getattr(got, field)
        assert torch.equal(g, getattr(plain, field)), field
        assert np.array_equal(g.cpu().numpy(), oracle["add"][k]), field
        assert np.array_equal(g.cpu().numpy(), oracle["min"][k]), field
    fam = table[np.clip(got.indices.cpu().numpy(), 0, table.size - 1)]
    want = np.where(fam, oracle["add"][1], oracle["min"][1])
    assert np.array_equal(got.secondary.cpu().numpy(), want)
    if dtype == "float32":
        torch.testing.assert_close(got.secondary, plain.secondary, rtol=1e-5,
                                   atol=1e-6)
    else:
        assert torch.equal(got.secondary, plain.secondary)


@pytest.mark.parametrize("kw,err", [
    (dict(filter_op="tagged", tag_table="int8"), ValueError),
    (dict(filter_op="tagged"), ValueError),
    (dict(slots=64), NotImplementedError),
    (dict(payload="2d"), NotImplementedError),
    (dict(payload="float64"), ValueError),
    (dict(num_sets=1 << 20), ValueError),
    (dict(elem_bytes=256), ValueError),
    (dict(filter_op="mul"), ValueError),
])
def test_hash_reorder_refuses_what_the_kernel_lacks(cuda, kw, err):
    kw = dict(kw)
    idx = torch.arange(64, dtype=torch.int32, device=cuda)
    payload = kw.pop("payload", "float32")
    vals = (torch.zeros(64, 2, device=cuda) if payload == "2d" else
            torch.zeros(64, device=cuda, dtype=getattr(torch, payload)))
    if kw.get("tag_table") == "int8":
        kw["tag_table"] = torch.zeros(66, dtype=torch.int8, device=cuda)
    before = dict(launch_counts)
    with pytest.raises(err):
        hash_ops.hash_reorder(idx, vals, **kw)
    assert launch_counts == before


@pytest.mark.parametrize("mode", ["sort", "hash"])
def test_serving_engine_kernels_match_plain(cuda, mode):
    """The fused serving engine through B2's tagged body (sort) or B3's
    tagged fold (hash) against its ``kernels=False`` twin: BFS and SSSP
    exactly (and equal to their solo runs), PPR within rtol 1e-5."""
    from repro_torch.graphs.generators import kron
    from repro_torch.serve import (GraphQuery, GraphServeConfig,
                                   GraphServingEngine)

    g = kron(scale=10, edge_factor=8, device=cuda)
    runs = []
    for kernels in (True, False):
        eng = GraphServingEngine(g, GraphServeConfig(
            query_slots=4, mode=mode, kernels=kernels), device=cuda)
        qs = [GraphQuery(kind, src, iters=6) for kind in ("bfs", "sssp", "ppr")
              for src in (0, 77)]
        for q in qs:
            eng.submit(q)
        before = dict(launch_counts)
        eng.run_to_completion(1000)
        torch.cuda.synchronize()
        tagged = ("segment_merge_tagged" if mode == "sort"
                  else "iru_reorder_tagged")
        launched = launch_counts[tagged] - before.get(tagged, 0)
        assert launched > 0 if kernels else launched == 0
        assert all(q.done for q in qs), [(q.status, q.error) for q in qs]
        runs.append((eng, qs))
    (eng, got), (_, want) = runs
    for a, b in zip(got, want):
        if a.kind == "ppr":
            np.testing.assert_allclose(a.result, b.result, rtol=1e-5,
                                       atol=1e-7)
        else:
            assert np.array_equal(a.result, b.result)
            assert np.array_equal(a.result, eng.solo_reference(a))


def _same_set_stream(length, rng, *, num_sets, sets=1):
    """Indices of ``4 * sets`` blocks that hash to ``sets`` sets (at most
    four distinct blocks a set), shuffled: hot sets with long duplicate
    runs, the round-cap and bank-bypass trips."""
    blocks, b = [], 0
    while len(blocks) < 4 * sets:
        if int(hash_ref.hash_set(np.asarray(b), num_sets)) < sets:
            blocks.append(b)
        b += 1
    return (rng.choice(np.asarray(blocks), length) * 32
            + rng.integers(0, 32, length)).astype(np.int32)


def _blocks_of(num_sets, want, count):
    """The first ``count`` blocks whose set satisfies ``want(set)``."""
    b = np.arange(1 << 16)
    return b[want(hash_ref.hash_set(b, num_sets))][:count]


def _full_sets_stream(length, rng, num_sets, slots, w):
    """Each window of ``w`` lanes: ``slots`` distinct indices of one set (a
    small set that flushes at its last arrival), ``slots`` arrivals of
    another with a duplicate (a small set that drains), ``slots`` distinct
    indices of a third with three duplicates between them, the last
    distinct one last (a hot set that flushes at its last arrival), the
    rest spread over the other sets; the four interleaved at random, each
    in its order."""
    b1, b2, b3 = (_blocks_of(num_sets, lambda s, k=k: s == k, 1)[0]
                  for k in (1, 2, 3))
    others = _blocks_of(num_sets, lambda s: s >= 4, 500)
    distinct = lambda b: b * 32 + rng.permutation(32)[:slots]
    out = []
    for s0 in range(0, length, w):
        span = min(w, length - s0)
        full, dup, hot = distinct(b1), distinct(b2), distinct(b3)
        dup[-1] = dup[0]
        hot = np.concatenate([hot[:-1], hot[[0, 1, 0]], hot[-1:]])
        rest = max(span - 3 * slots - 3, 0)
        filler = (others[rng.integers(0, others.size, rest)] * 32
                  + rng.integers(0, 32, rest))
        seqs = [list(full), list(dup), list(hot), list(filler)]
        tags = np.repeat(np.arange(4), [len(q) for q in seqs])
        rng.shuffle(tags)
        out += [seqs[k].pop(0) for k in tags]
    return np.asarray(out[:length], np.int32)


def _geo_stream(kind, length, rng, num_sets, slots=None, w=None):
    if kind == "one_set":
        return _same_set_stream(length, rng, num_sets=num_sets)
    if kind == "two_sets":
        return _same_set_stream(length, rng, num_sets=num_sets, sets=2)
    if kind == "full_sets":
        return _full_sets_stream(length, rng, num_sets, slots, w)
    if kind == "one_partition":  # every lane in partition 0 (of 1, 2 or 4)
        pool = _blocks_of(num_sets, lambda s: s % 4 == 0, 300)
        return (pool[rng.integers(0, pool.size, length)] * 32
                + rng.integers(0, 32, length)).astype(np.int32)
    return _hash_stream(kind, length, rng)


def _check_stream(got, plain, oracle, op, dtype):
    """Exact against the oracle (payloads too: the kernel folds in stream
    order, like the oracle); against the plain version exact but for float
    add (rtol 1e-5, see the module docstring)."""
    for k, field in enumerate(("indices", "secondary", "positions",
                               "active")):
        g = getattr(got, field)
        assert np.array_equal(g.cpu().numpy(), oracle[k]), field
        if field == "secondary" and op == "add" and dtype == "float32":
            torch.testing.assert_close(g, plain.secondary, rtol=1e-5,
                                       atol=1e-6)
        else:
            assert torch.equal(g, getattr(plain, field)), field


# (geometry, stream, length, window): ragged last windows, n <= w (one
# window), the paper's 8192-lane window, hot and one-set windows; full sets
# (small ones that flush at their last arrival or drain with a duplicate, a
# hot one that flushes at its last arrival) and every lane in one partition
WINDOW_CASES = [((1024, 32), "wide", 20_000, 8192),
                ((1024, 32), "kron", 65_536, 8192),
                ((1024, 32), "wide", 3000, 8192),
                ((1024, 32), "hot", 5000, 1000),
                ((1024, 32), "one_set", 20_000, 4096),
                ((16, 4), "wide", 3000, 256),
                ((16, 4), "hot", 3000, 333),
                ((16, 4), "two_sets", 4000, 512),
                ((8, 2), "lanes", 3000, 1024),
                ((1024, 32), "full_sets", 20_000, 8192),
                ((16, 4), "full_sets", 3000, 256),
                ((1024, 32), "one_partition", 20_000, 8192),
                ((16, 4), "one_partition", 3000, 512)]


@pytest.mark.parametrize("geometry,kind,length,w", WINDOW_CASES)
@pytest.mark.parametrize("n_partitions", [1, 2, 4])
@pytest.mark.parametrize("live", [None, 0, "part", "all", "mid_warp"])
@pytest.mark.parametrize("op,dtype,cap", [
    ("add", "float32", None), ("add", "float32", "trip"),
    ("min", "int32", "no_trip"), ("min", "int32", "trip"),
    ("max", "float32", None), (None, "float32", "trip")])
def test_windowed_body_matches_oracle_and_plain(cuda, geometry, kind, length,
                                                w, n_partitions, live, op,
                                                dtype, cap):
    """B3's windowed body, every window against the numpy oracle (the
    banked, cap-aware ``hash_ref`` of ``core.iru``) and the whole stream
    against the plain window loop (``kernels=False``), in one launch."""
    from repro_torch.core import iru

    num_sets, slots = geometry
    if num_sets % n_partitions:
        pytest.skip("the geometry does not split over the partitions")
    rng = np.random.default_rng(length + w + n_partitions)
    idx = _geo_stream(kind, length, rng, num_sets, slots, w)
    vals = (rng.uniform(0.0, 1.0, length).astype(np.float32)
            if dtype == "float32"
            else rng.integers(-1000, 1000, length).astype(np.int32))
    m = {None: length, 0: 0, "part": length * 3 // 5, "all": length,
         "mid_warp": min(length, w + 13)}[live]  # 13 lanes into window 2
    round_cap = {None: None, "trip": 2, "no_trip": 64}[cap]
    cfg = iru.IRUConfig(mode="hash", num_sets=num_sets, slots=slots,
                        n_partitions=n_partitions, n_banks=1, filter_op=op,
                        round_cap=round_cap, window_elems=w)
    n_live = (None if live is None
              else torch.tensor(m, dtype=torch.int32, device=cuda))
    before = dict(launch_counts)
    got = iru.iru_reorder(t(idx, cuda), t(vals, cuda), config=cfg,
                          n_live=n_live)
    torch.cuda.synchronize()
    assert launch_counts["iru_reorder_windowed"] == before.get(
        "iru_reorder_windowed", 0) + 1
    assert launch_counts["iru_reorder"] == before.get("iru_reorder", 0)
    plain = iru.iru_reorder(t(idx, cuda), t(vals, cuda), config=cfg,
                            n_live=n_live, kernels=False)
    oracle = iru._hash_ref_host(idx, vals, cfg, None if live is None else m)
    _check_stream(got, plain, oracle, op, dtype)


BANKED_CASES = [((1024, 32), "wide", 20_000), ((1024, 32), "kron", 65_536),
                ((1024, 32), "one_set", 20_000), ((1024, 32), "hot", 3000),
                ((16, 4), "wide", 3000), ((16, 4), "two_sets", 3000),
                ((8, 2), "lanes", 3000)]


@pytest.mark.parametrize("geometry,kind,length", BANKED_CASES)
@pytest.mark.parametrize("n_partitions", [2, 4])
@pytest.mark.parametrize("live", [None, 0, "part"])
@pytest.mark.parametrize("op,dtype", [("add", "float32"), ("min", "int32"),
                                      ("max", "float32"), (None, "float32")])
def test_banked_b3_matches_oracle_and_plain(cuda, geometry, kind, length,
                                            n_partitions, live, op, dtype):
    """Whole-stream B3 with the banked layout (its bypass decided on the
    device) against ``ref.hash_reorder_ref_banked`` and the banked plain
    version."""
    num_sets, slots = geometry
    if num_sets % n_partitions:
        pytest.skip("the geometry does not split over the partitions")
    rng = np.random.default_rng(length + 3 * n_partitions)
    idx = _geo_stream(kind, length, rng, num_sets)
    vals = (rng.uniform(0.0, 1.0, length).astype(np.float32)
            if dtype == "float32"
            else rng.integers(-1000, 1000, length).astype(np.int32))
    m = {None: length, 0: 0, "part": length * 2 // 3}[live]
    n_live = (None if live is None
              else torch.tensor(m, dtype=torch.int32, device=cuda))
    kw = dict(num_sets=num_sets, slots=slots, filter_op=op,
              n_partitions=n_partitions, n_live=n_live)
    before = dict(launch_counts)
    got = hash_ops.hash_reorder(t(idx, cuda), t(vals, cuda), **kw)
    torch.cuda.synchronize()
    assert launch_counts["iru_reorder_banked"] == before.get(
        "iru_reorder_banked", 0) + 1
    assert launch_counts["iru_reorder"] == before.get("iru_reorder", 0)
    plain = hash_ops.hash_reorder(t(idx, cuda), t(vals, cuda), kernels=False,
                                  **kw)
    oracle = hash_ref.ragged_oracle(
        hash_ref.hash_reorder_ref_banked, idx, vals, m, num_sets=num_sets,
        slots=slots, filter_op=op, n_partitions=n_partitions)
    _check_stream(got, plain, oracle, op, dtype)


def _family_set_stream(length, rng, num_sets):
    """Half the lanes in set 3's blocks (a hot set), the rest spread."""
    blocks = _blocks_of(num_sets, lambda s: s == 3, 4)
    idx = rng.integers(0, 6000, length)
    sel = rng.random(length) < 0.5
    idx[sel] = (blocks[rng.integers(0, blocks.size, int(sel.sum()))] * 32
                + rng.integers(0, 32, int(sel.sum())))
    return idx.astype(np.int32), blocks


def _padded_live(idx, vals, oracle_of, n):
    """A live count near n / 7 that leaves an odd number of survivors and
    n - n_live a multiple of neither 4 nor 16."""
    for m in range(n // 7, n // 7 + 64):
        if (n - m) % 4 == 0:
            continue
        if int(oracle_of(m)[3].sum()) % 2 == 1:
            return m
    raise AssertionError("no live count with odd survivors")


# (geometry, stream, length): the whole-stream body on padded streams (a
# small live prefix), over 1, 2, 4 and 8 partitions (one mark-scan pass) and
# 16 (two passes); one_partition trips the bank bypass at every count above
# 1, family_set fills a hot set with one family's lanes
PADDED_CASES = [((1024, 32), "wide", 40_000), ((1024, 32), "kron", 65_536),
                ((1024, 32), "one_partition", 20_000),
                ((1024, 32), "family_set", 30_000),
                ((16, 4), "family_set", 5000), ((16, 4), "wide", 5000)]


@pytest.mark.parametrize("geometry,kind,length", PADDED_CASES)
@pytest.mark.parametrize("n_partitions", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("op,dtype", [("add", "float32"), ("min", "int32"),
                                      (None, "float32"),
                                      ("tagged", "float32"),
                                      ("tagged", "int32")])
def test_hash_reorder_on_padded_streams(cuda, geometry, kind, length,
                                        n_partitions, op, dtype):
    """B3's whole-stream body on a stream whose live prefix is a seventh of
    it (odd survivors, a dead stretch of no multiple of 4): the layout and
    folds equal ``ragged_oracle(hash_reorder_ref_banked)`` (tagged: its add
    result on add lanes, its min result on min lanes) and the plain
    version; one launch under the body's count."""
    num_sets, slots = geometry
    rng = np.random.default_rng(length + 5 * n_partitions)
    table = None
    if kind == "family_set":
        idx, blocks = _family_set_stream(length, rng, num_sets)
    else:
        idx = _geo_stream(kind, length, rng, num_sets)
    if op == "tagged":
        table = rng.random(int(idx.max()) + 2) < 0.5
        if kind == "family_set":  # set 3's lanes all in the min family
            for b in blocks:
                table[b * 32:(b + 1) * 32] = False
    vals = (rng.uniform(0.0, 1.0, length).astype(np.float32)
            if dtype == "float32"
            else rng.integers(-1000, 1000, length).astype(np.int32))

    def oracle_of(m, fold=op):
        return hash_ref.ragged_oracle(
            hash_ref.hash_reorder_ref_banked, idx, vals, m,
            num_sets=num_sets, slots=slots,
            filter_op="add" if fold == "tagged" else fold,
            n_partitions=n_partitions)

    m = _padded_live(idx, vals, oracle_of, length)
    kw = dict(num_sets=num_sets, slots=slots, filter_op=op,
              n_partitions=n_partitions,
              n_live=torch.tensor(m, dtype=torch.int32, device=cuda),
              tag_table=None if table is None else t(table, cuda))
    key = ("iru_reorder_tagged" if op == "tagged" else "iru_reorder_banked"
           if n_partitions > 1 else "iru_reorder")
    before = dict(launch_counts)
    got = hash_ops.hash_reorder(t(idx, cuda), t(vals, cuda), **kw)
    torch.cuda.synchronize()
    assert launch_counts[key] == before.get(key, 0) + 1
    assert sum(launch_counts.values()) == sum(before.values()) + 1
    plain = hash_ops.hash_reorder(t(idx, cuda), t(vals, cuda), kernels=False,
                                  **kw)
    oracle = oracle_of(m)
    if op == "tagged":
        low = oracle_of(m, "min")
        fam = table[np.clip(oracle[0], 0, table.size - 1)]
        oracle = (oracle[0], np.where(fam, oracle[1], low[1]), oracle[2],
                  oracle[3])
    _check_stream(got, plain, oracle, "add" if op == "tagged" else op,
                  dtype)


@pytest.mark.parametrize("kw,err", [
    (dict(window_elems=256, payload="2d"), NotImplementedError),
    (dict(window_elems=8193), NotImplementedError),
    (dict(window_elems=8192, num_sets=8192, n_partitions=8),
     NotImplementedError),
    (dict(payload="2d", n_partitions=4, filter_op="min", round_cap=64),
     NotImplementedError),
    (dict(slots=33, window_elems=256), NotImplementedError),
    (dict(num_sets=30, n_partitions=4), ValueError),
    (dict(window_elems=256, num_sets=30, n_partitions=4), ValueError),
])
def test_b3_bodies_refuse_what_they_lack(cuda, kw, err):
    """Each refusal names the slice that brings it; nothing launches."""
    kw = dict(kw)
    idx = torch.arange(64, dtype=torch.int32, device=cuda)
    vals = (torch.zeros(64, 2, device=cuda) if kw.pop("payload", None)
            else torch.zeros(64, device=cuda))
    if kw.get("tag_table") == "bool":
        kw["tag_table"] = torch.zeros(66, dtype=torch.bool, device=cuda)
    before = dict(launch_counts)
    with pytest.raises(err) as info:
        hash_ops.hash_reorder(idx, vals, **kw)
    if err is NotImplementedError:
        assert "slice" in str(info.value) and "ROADMAP §B" in str(info.value)
    assert launch_counts == before


def _mixed_cap_stream(length, rng, num_sets):
    """A third of the lanes in four blocks of set 0 (partition 0 of 2 or 4:
    past a small round cap), the rest spread thin over the other
    partitions' sets (under it)."""
    hot = _blocks_of(num_sets, lambda s: s == 0, 4)
    cold = _blocks_of(num_sets, lambda s: s % 4 != 0, 4000)
    sel = rng.random(length) < 1 / 3
    blocks = np.where(sel, hot[rng.integers(0, hot.size, length)],
                      cold[rng.integers(0, cold.size, length)])
    return (blocks * 32 + rng.integers(0, 32, length)).astype(np.int32)


def _cap_stream(kind, length, rng, num_sets):
    if kind == "mixed":
        return _mixed_cap_stream(length, rng, num_sets)
    if kind == "arange":  # the stream the refusal tests used
        return np.arange(length, dtype=np.int32)
    if kind == "negative":  # indices of both signs: the sort's sign bit
        return rng.integers(-3000, 3000, length).astype(np.int32)
    return _geo_stream(kind, length, rng, num_sets)


def _family_oracle(oracle_of, op, table):
    """The oracle of ``op``; tagged: its layout with the add result on add
    lanes and the min result on min lanes."""
    if op != "tagged":
        return oracle_of(op)
    add, low = oracle_of("add"), oracle_of("min")
    fam = table[np.clip(add[0], 0, table.size - 1)]
    return (add[0], np.where(fam, add[1], low[1]), add[2], add[3])


# (geometry, stream, length, round cap): caps that hot sets pass (kron's
# hubs, a few indices, one set, negative indices), a cap one partition
# passes and the others do not (mixed), a cap no set reaches, the bypass
# under a cap (every lane in one partition), and the refusal tests' old
# stream (64 lanes, round cap 64: no set reaches it)
CAP_CASES = [((1024, 32), "kron", 65_536, 2), ((1024, 32), "hot", 3000, 1),
             ((1024, 32), "one_set", 20_000, 4),
             ((1024, 32), "mixed", 40_000, 4),
             ((1024, 32), "wide", 20_000, 1_000_000),
             ((1024, 32), "one_partition", 20_000, 1),
             ((1024, 32), "negative", 30_000, 1),
             ((16, 4), "hot", 3000, 3), ((16, 4), "mixed", 5000, 8),
             ((8, 2), "lanes", 3000, 2), ((1024, 32), "arange", 64, 64)]


@pytest.mark.parametrize("geometry,kind,length,round_cap", CAP_CASES)
@pytest.mark.parametrize("n_partitions", [1, 4])
@pytest.mark.parametrize("live", [None, "part", "padded"])
@pytest.mark.parametrize("op,dtype", [("add", "float32"), ("min", "int32"),
                                      ("max", "float32"),
                                      ("add", "int32"),
                                      ("tagged", "float32"),
                                      ("tagged", "int32")])
def test_hash_reorder_round_cap_matches_plain_and_oracle(
        cuda, geometry, kind, length, round_cap, n_partitions, live, op,
        dtype):
    """B3's whole-stream body under a round cap: each partition past it
    (decided on the device, after the bank bypass, on live lanes only)
    takes the dense fallback, the others the hash; the result equals
    ``ragged_oracle(hash_reorder_ref_banked, round_cap=)`` bit for bit
    (tagged: per family) and the plain version, in one launch, under
    ``set_sync_debug_mode("error")``, counted under
    ``iru_reorder_round_cap``.  A cap no set reaches equals the uncapped
    call."""
    num_sets, slots = geometry
    if num_sets % n_partitions:
        pytest.skip("the geometry does not split over the partitions")
    rng = np.random.default_rng(length + 11 * n_partitions + round_cap)
    idx = _cap_stream(kind, length, rng, num_sets)
    table = rng.random(int(np.abs(idx).max()) + 2) < 0.5
    vals = (rng.uniform(0.0, 1.0, length).astype(np.float32)
            if dtype == "float32"
            else rng.integers(-1000, 1000, length).astype(np.int32))

    def oracle_of(m, fold):
        return hash_ref.ragged_oracle(
            hash_ref.hash_reorder_ref_banked, idx, vals, m,
            num_sets=num_sets, slots=slots, filter_op=fold,
            n_partitions=n_partitions, round_cap=round_cap)

    m = {None: length, "part": length * 3 // 5,
         "padded": length // 7}[live]
    kw = dict(num_sets=num_sets, slots=slots, filter_op=op,
              n_partitions=n_partitions, round_cap=round_cap,
              n_live=(None if live is None
                      else torch.tensor(m, dtype=torch.int32, device=cuda)),
              tag_table=t(table, cuda) if op == "tagged" else None)
    key = "iru_reorder_round_cap"
    idx_t, vals_t = t(idx, cuda), t(vals, cuda)
    before = dict(launch_counts)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = hash_ops.hash_reorder(idx_t, vals_t, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert launch_counts[key] == before.get(key, 0) + 1
    assert sum(launch_counts.values()) == sum(before.values()) + 1
    plain = hash_ops.hash_reorder(idx_t, vals_t, kernels=False, **kw)
    oracle = _family_oracle(lambda f: oracle_of(m, f), op, table)
    _check_stream(got, plain, oracle, "add" if op == "tagged" else op, dtype)
    capped = hash_ref.max_round_bound(
        idx[:m], num_sets=num_sets, slots=slots) > round_cap
    if not capped:  # no set reaches the cap: the uncapped call
        uncapped = hash_ops.hash_reorder(idx_t, vals_t,
                                         **dict(kw, round_cap=None))
        for a, b in zip(got, uncapped):
            assert torch.equal(a, b)


# (geometry, stream, length, window, round cap); the refusal tests' old
# tagged window (64 lanes of 256)
TAGGED_WINDOW_CASES = [((1024, 32), "kron", 65_536, 8192, 64),
                       ((1024, 32), "kron", 65_536, 8192, 2),
                       ((1024, 32), "wide", 20_000, 8192, None),
                       ((1024, 32), "hot", 5000, 1000, 2),
                       ((1024, 32), "one_set", 20_000, 4096, None),
                       ((1024, 32), "full_sets", 20_000, 8192, 64),
                       ((1024, 32), "one_partition", 20_000, 8192, 1),
                       ((16, 4), "hot", 3000, 333, 3),
                       ((16, 4), "full_sets", 3000, 256, None),
                       ((8, 2), "lanes", 3000, 1024, None),
                       ((1024, 32), "arange", 64, 256, None)]


@pytest.mark.parametrize("geometry,kind,length,w,round_cap",
                         TAGGED_WINDOW_CASES)
@pytest.mark.parametrize("n_partitions", [1, 4])
@pytest.mark.parametrize("live", [None, "part", "mid_warp"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_windowed_body_tagged_matches_oracle_and_plain(
        cuda, geometry, kind, length, w, round_cap, n_partitions, live,
        dtype):
    """B3's windowed body tagged: every fold (small sets, hot sets, the
    round-cap fallback) under its index's family.  Every window equals the
    numpy oracle per family (its add result on add lanes, its min result
    on min lanes) and the plain window loop, in one launch."""
    from repro_torch.core import iru

    num_sets, slots = geometry
    if num_sets % n_partitions:
        pytest.skip("the geometry does not split over the partitions")
    rng = np.random.default_rng(length + w + 3 * n_partitions)
    idx = _cap_stream(kind, length, rng, num_sets) if kind == "arange" \
        else _geo_stream(kind, length, rng, num_sets, slots, w)
    table = rng.random(int(idx.max()) + 2) < 0.5
    vals = (rng.uniform(0.0, 1.0, length).astype(np.float32)
            if dtype == "float32"
            else rng.integers(-1000, 1000, length).astype(np.int32))
    m = {None: length, "part": length * 3 // 5,
         "mid_warp": min(length, w + 13)}[live]
    cfg = iru.IRUConfig(mode="hash", num_sets=num_sets, slots=slots,
                        n_partitions=n_partitions, n_banks=1,
                        filter_op="tagged", round_cap=round_cap,
                        window_elems=w)
    n_live = (None if live is None
              else torch.tensor(m, dtype=torch.int32, device=cuda))
    tags = t(table, cuda)
    before = dict(launch_counts)
    got = iru.iru_reorder(t(idx, cuda), t(vals, cuda), config=cfg,
                          n_live=n_live, tag_table=tags)
    torch.cuda.synchronize()
    assert launch_counts["iru_reorder_windowed"] == before.get(
        "iru_reorder_windowed", 0) + 1
    assert sum(launch_counts.values()) == sum(before.values()) + 1
    plain = iru.iru_reorder(t(idx, cuda), t(vals, cuda), config=cfg,
                            n_live=n_live, tag_table=tags, kernels=False)
    oracle = _family_oracle(
        lambda f: iru._hash_ref_host(idx, vals, dataclasses.replace(
            cfg, filter_op=f), None if live is None else m), "tagged", table)
    _check_stream(got, plain, oracle, "add", dtype)


def test_windowed_tagged_keeps_two_windows_an_sm(cuda):
    """The tagged variant of the windowed body at the paper's geometry keeps
    two windows (CTAs) resident on an SM, as the untagged one does."""
    for op in ("add", "tagged"):
        assert hash_ops.windowed_occupancy(8192, 1024, 4, op) == 2, op

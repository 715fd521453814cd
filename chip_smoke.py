#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on a CUDA card (an H100).

Run from the repo root with no arguments:  python3 chip_smoke.py

Phases, in order (any failure exits non-zero and prints no result line):
  1. build   -- compiles every kernel of the port (nvcc, sm_90a) into
               build/kernels/ and prints the seconds and each kernel's
               register / shared-memory report;
  2. kernels -- holds each kernel against its plain PyTorch version on the
               card at full size: B1 (block-reuse gather) on kron-20's edge
               arrays with real expansions' monotone offsets (half the nodes,
               and a gappy quarter of them) and a shuffled stream, at
               (group, window) = (8, 128) and (256, 256), exactly;
               B2 (segment merge) on kron-20's sorted destination stream with
               an active prefix, for add (f32, rtol 1e-5), min (f32, int32)
               and max, survivors and min/max exactly, and B2's tagged body
               (the fused min+add merge, tags (idx >> 17) & 1: min-family
               lanes exactly, add-family lanes within rtol 1e-5), and two
               calls of B2 add and tagged on the same stream, which must be
               bit-identical (their largest difference is printed); B3 (IRU hash) on
               kron-20's PageRank destination stream (add, f32), a half-graph
               expansion stream with its live prefix (min on int32 and f32,
               and no merge) and a stream that hammers eight sets (max, many
               rounds): indices, positions, active and min/max exactly, add
               within rtol 1e-5; and B3's tagged fold on the PageRank stream
               with the same tags;
  3. banked/windowed -- the paper's IRU geometry (IRU_HASH: 1024 x 32 sets
               over 4 partitions x 2 banks, 8192-lane windows, round cap 64).
               B3's windowed body (one launch) on kron-20's PageRank stream
               (add and min, f32) equals the numpy oracle on every window,
               bit for bit, and the plain window loop on the whole stream
               (min exactly, add within rtol 1e-5; max abs and relative
               error printed); two 1M-lane streams built to trip the
               round-cap fallback and the bank bypass are held the same way,
               and each prints how many windows took its branch (each count
               must be non-zero).  Whole-stream B3 with the banked layout (4
               partitions, no window) equals the banked plain version at
               PageRank's shape (add, rtol 1e-5) and, without a merge,
               hash_reorder_ref_banked exactly.  Then BFS, SSSP and PageRank
               (20 iterations) on kron-20 and delaunay-1024 through
               FrontierPipeline(mode="hash", iru_config=IRUConfig(**IRU_HASH))
               against the host oracles (BFS/SSSP exactly, PageRank rtol
               1e-4), and reorder_frontier with IRU_HASH and with 4
               partitions and no window, each run with its launch counts
               zeroed before and read after; then both bodies' CUDA-event
               times and a profile of one call each;
  4. apps    -- BFS and SSSP from node 0 on kron-20 and delaunay-1024, and
               PageRank on kron-20, through the kernels (kernels=True,
               3-bucket CapacityPolicy), once with mode="sort" (B1, B2) and
               once with mode="hash" (B1, B3).  Each run is held against the
               same run through the plain path (kernels=False) -- exactly for
               BFS/SSSP, rtol 1e-5 for PageRank; hash-mode PageRank's and
               delaunay SSSP's plain runs are cut to 5 and 300 iterations,
               beside a kernel run of that depth -- and against the port's
               numpy host oracle (PageRank at rtol 1e-4: the oracle sums each
               hub's ~1e5 contributions sequentially in f32).  PageRank runs
               20 iterations.  The launch counts of each run are zeroed before
               it and read after it; a kernel of the path with no launch
               fails the run;
  5. figures -- the paper's evaluation path.  (a) The figure harness
               (repro_torch.figures) at its own scale (DATASET_KW): all 18
               cells (BFS, SSSP, PageRank x six datasets) with the IRU traces
               taken by the host apps through reorder_frontier with IRU_HASH
               on the card (kernel B3's windowed body, one launch a
               reorder), each held against the same cell through the numpy
               oracle (engine="hash_ref"): every event's indices, active
               mask and atomic flag and iru_elements equal, BFS/SSSP results
               equal, PageRank bit for bit (else its largest difference is
               printed and rtol 1e-6 holds); then the six figure drivers'
               rows (Figs. 4, 11-15), per cell and MEAN: cost-model counts
               of a GTX 980 model over traces taken on this card.  (b)
               Figs. 14 and 15 at the size of the graphs the datasets
               imitate (ca 1024^2, cond 40k, delaunay-1024, human 22k,
               kron-20, msdoor 75^3), BFS/SSSP/PageRank (5 iterations)
               through FrontierPipeline.run_instrumented in baseline and
               with IRU_HASH (B1, B3 windowed; at least one launch a step,
               B3 exactly one), each event reduced on the card as it
               arrives: accesses per warp, improvement, filtered fraction,
               trace wall seconds; each run equals the same pipeline's run()
               (PageRank rtol 1e-5), the two modes agree, and on kron-20 and
               delaunay-1024 BFS/SSSP equal the host oracles.  (c) bfs_jit
               on both graphs against the BFS oracle exactly, and
               pagerank_jit(use_iru=True) on kron-20 (20 iterations, B2
               once an iteration) within rtol 1e-4, atol 1e-7 of it;
  6. serving -- 12 queries (4 BFS, 4 SSSP, 4 PPR of 20 iterations, seeded
               sources of nonzero degree) through GraphServingEngine on
               tile_csr(kron-20, 8) with the default GraphServeConfig (8
               slots, so four queries wait): fused baseline (B1 and the
               tagged scatter), fused sort (B1, B2 tagged), fused hash (B1,
               B3 tagged), split hash (B1, B3) and fused sort through the
               plain versions.  Every query must end done; BFS and SSSP
               equal their solo pipeline runs bit for bit (one of each also
               the host oracles), PPR within rtol 1e-5 of solo; fused sort
               equals its plain twin.  Each run prints its wall time,
               queries/s, ticks, overflow and quarantine counts, launch
               counts and peak device memory.  Then one more fused sort
               run (untimed, its launches not counted) keeps two of its
               ticks at the top rung (8 m lanes): B2's tagged body is held
               against its plain version on the sorted stream of the tick
               with the most live lanes, B3's tagged fold on the expansion
               stream and n_live of the tick with the fewest (B3's plain
               version takes time in proportion to live lanes times width),
               and B2's call on that tick is profiled kernel by kernel;
  7. partitioned -- the edge-partitioned pipeline (repro_torch.dist): four
               shards of one graph held on the card and stepped in turn,
               kernels B1, B2 and B3 launched per shard, the boundary
               exchange between scatter and update.  On partition_csr(
               kron-20, 4), BFS, SSSP and PageRank (20 iterations) in
               baseline, sort and hash mode, each with the exact codec and
               with compress=True (BFS: flag, PageRank: int8_ef, SSSP stays
               exact), and PageRank once with IRU_HASH (B3's windowed body
               per shard): BFS and SSSP equal the single-device pipeline of
               the same mode and the host oracle bit for bit, PageRank is
               within rtol = atol = 1e-4 of single-device with the exact
               codec (and rtol 1e-4 with atol 0) and 2e-3 with int8_ef (the
               reference's tolerances; max abs, max relative and L1 relative
               errors printed).  BFS on partition_csr(delaunay-1024, 4) in
               hash mode with compress=True under a 3-rung CapacityPolicy,
               bit-identical, hopping rungs.  Then the 12-query serving mix
               through the engine on partition_csr(tile_csr(kron-20, 8), 4)
               in fused hash and fused sort, and on the same composite at
               P=3 in fused hash (P=4 puts whole tenants on each shard, P=3
               cuts two of them, so the tagged exchange runs): BFS/SSSP
               equal phase 6's single-device run of the same mode, PPR
               within rtol 1e-5 of it.  Each line prints supersteps, bucket
               hops, wall seconds beside single-device, boundary bytes per
               superstep (raw and on the wire) and each shard's launches,
               every one of which must include the kernels its mode needs;
               each partition's build seconds and device bytes are printed;
  8. timings -- CUDA-event times after a warm-up for each kernel, its plain
               version and one library call computing the same function (B2
               tagged and B3 have none), the bound (bytes over the card's
               3.35 TB/s), at PageRank's shape; B1 also at a BFS level's
               shape (the gappy quarter-node expansion) beside index_select;
  9. profile -- device time by kernel and the device's busy share over short
               windows of PageRank on kron-20 (sort and hash), SSSP on
               delaunay-1024, three serving ticks (fused sort and fused
               hash), and B2's and B3's kernels in one call each at
               PageRank's shape (add, and the tagged bodies).

It prints the card's name and power limit, one JSON line naming the kernels
with their numbers, and last {"ok": true, "device": {...}}.  It needs one
CUDA card and exits non-zero without one, or when run outside a checkout of
the repo.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak (NVIDIA data sheet)
SEED = 0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def event_ms(fn, reps: int = 10) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_build():
    from repro_torch.kernels import _build

    seconds = _build.build()
    print(f"build: {seconds:.3f} s ({len(_build.SOURCES)} sources, parallel "
          f"nvcc) into {_build.BUILD_DIR.relative_to(ROOT)}")
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"lib{name}.log")
        used = [ln.split("info    : ")[-1] for ln in log.read_text().splitlines()
                if "Used" in ln] if log.exists() else []
        print(f"  {name}: {len(used)} entry points; " + "; ".join(
            sorted(set(used))))


def make_graphs(dev):
    from repro_torch.graphs.csr import from_edges
    from repro_torch.graphs.generators import delaunay_edges, kron_edges

    graphs = {}
    for name, edges in (("kron20", lambda: kron_edges(20, 16)),
                        ("delaunay1024", lambda: delaunay_edges(1024))):
        t0 = time.perf_counter()
        src, dst, n = edges()
        w = np.random.default_rng(SEED).uniform(1.0, 64.0, src.shape[0])
        graphs[name] = from_edges(src, dst, n, w.astype(np.float32),
                                  symmetrize=True, device=dev)
        g = graphs[name]
        print(f"graph {name}: {g.n_nodes} nodes, {g.n_edges} edges, max "
              f"degree {int(g.degrees().max())}, built in "
              f"{time.perf_counter() - t0:.1f} s")
    return graphs


def phase_kernels(g):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.graphs.csr import expand_frontier, frontier_from_mask
    from repro_torch.kernels.coalesced_gather import ops as gather_ops
    from repro_torch.kernels.coalesced_gather.ref import (
        coalesced_gather_ref, window_contract_ok)
    from repro_torch.kernels.segment_merge import ops as merge_ops
    from repro_torch.kernels.segment_merge.ref import segment_merge_ref

    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # B1: real expansions' offsets (half the nodes, and a quarter: a BFS
    # level's gappy offsets) and a shuffled stream
    mask = torch.rand(g.n_nodes, generator=gen, device=dev) < 0.5
    ef = expand_frontier(g, frontier_from_mask(mask), gather="torch")
    mono = ef.eids[:int(ef.n_valid)]
    shuffled = mono[torch.randperm(mono.numel(), generator=gen, device=dev)]
    quarter = torch.rand(g.n_nodes, generator=gen, device=dev) < 0.25
    eq = expand_frontier(g, frontier_from_mask(quarter), gather="torch")
    sparse = eq.eids[:int(eq.n_valid)]
    gerr = 0.0
    for name, off in (("monotone", mono), ("sparse", sparse),
                      ("shuffled", shuffled)):
        for group, window in ((8, 128), (256, 256)):
            ok = bool(window_contract_ok(off, group=group, window=window))
            m = off.numel() // group * group
            grp = off[:m].reshape(-1, group)
            share = ((grp.max(1).values < (grp.min(1).values // window + 2)
                      * window).float().mean().item())
            d, w = gather_ops.csr_edge_gather(g.col_idx, off, g.weights,
                                              group=group, window=window)
            d1 = gather_ops.csr_edge_gather(g.col_idx, off, group=group,
                                            window=window)
            want_d = coalesced_gather_ref(g.col_idx, off)
            want_w = coalesced_gather_ref(g.weights, off)
            torch.cuda.synchronize()
            check(torch.equal(d, want_d) and torch.equal(d1, want_d)
                  and torch.equal(w, want_w),
                  f"B1 {name} ({group},{window}) equals the plain gather")
            gerr = max(gerr, (w - want_w).abs().max().item(),
                       (d.long() - want_d.long()).abs().max().item())
            print(f"B1 {name:8s} group={group:3d} window={window:3d}: "
                  f"{off.numel()} lanes, contract holds in {share:.4f} of "
                  f"groups (everywhere: {ok}), equal to plain")

    # B2: the sorted destination stream of the full expansion + active prefix
    dsts, order = torch.sort(g.col_idx, stable=True)
    srcs = g.edge_sources()[order]
    deg = g.degrees().clamp(min=1).float()
    n = dsts.numel()
    active = torch.arange(n, device=dev) < (n * 7) // 10
    contrib = (1.0 / g.n_nodes / deg)[srcs.long()]   # PageRank's payload
    relax = g.weights[order]                         # SSSP-like payload
    depth = torch.randint(0, 64, (n,), generator=gen, device=dev,
                          dtype=torch.int32)         # BFS-like payload
    merr = 0.0
    for op, vals in (("add", contrib), ("min", relax), ("min", depth),
                     ("max", relax)):
        for act in (None, active):
            got_v, got_s = merge_ops.segment_merge(dsts, vals, op=op,
                                                   active=act)
            want_v, want_s = segment_merge_ref(dsts, vals, op, act)
            torch.cuda.synchronize()
            check(torch.equal(got_s, want_s), f"B2 {op} survivors")
            if op == "add":
                check(torch.allclose(got_v, want_v, rtol=1e-5, atol=0.0),
                      "B2 add within rtol 1e-5")
            else:
                check(torch.equal(got_v, want_v), f"B2 {op} exact")
            merr = max(merr, (got_v.double() - want_v.double()).abs().max()
                       .item())
            print(f"B2 {op} {str(vals.dtype):13s} active="
                  f"{'all' if act is None else '70% prefix'}: {n} lanes, "
                  f"{int(got_s.sum())} survivors, matches plain")
    # B2's tagged body: a per-node family table, so every run is uniform-tag
    table = family_table(g)
    tags = table[dsts.long()]
    terr = 0.0
    for vals in (contrib, depth):
        for act in (None, active):
            got_v, got_s = merge_ops.segment_merge(dsts, vals, op="tagged",
                                                   active=act, tags=tags)
            want_v, want_s = segment_merge_ref(dsts, vals, "tagged", act,
                                               tags)
            torch.cuda.synchronize()
            check_tagged(got_v, want_v, tags, f"B2 tagged {vals.dtype}")
            check(torch.equal(got_s, want_s), "B2 tagged survivors")
            terr = max(terr, (got_v.double() - want_v.double()).abs().max()
                       .item())
            print(f"B2 tagged {str(vals.dtype):13s} active="
                  f"{'all' if act is None else '70% prefix'}: {n} lanes, "
                  f"{int(tags.sum())} add-family lanes, matches plain")
    # repeated calls on the hub-heavy stream: the f32 sums are deterministic
    for op, kw in (("add", {}), ("tagged", {"tags": tags})):
        first, _ = merge_ops.segment_merge(dsts, contrib, op=op, **kw)
        again, _ = merge_ops.segment_merge(dsts, contrib, op=op, **kw)
        torch.cuda.synchronize()
        diff = max_abs_err(first, again)
        print(f"B2 {op} f32, two calls on the same {n} lanes: max abs "
              f"difference {diff:.3g}")
        check(torch.equal(first, again),
              f"B2 {op}: repeated calls bit-identical")
    herr, herr_tagged = phase_hash_kernel(g, ef, gen)
    return dsts, contrib, sparse, {
        "coalesced_gather": gerr, "segment_merge": merr,
        "segment_merge_tagged": terr, "iru_reorder": herr,
        "iru_reorder_tagged": herr_tagged}


def family_table(g):
    """A per-node merge family for the tagged kernels' checks: node ids in
    alternate 2^17-blocks are the add family; the padding entry is min."""
    ids = torch.arange(g.n_nodes + 1, device=g.device)
    table = ((ids >> 17) & 1).bool()
    table[-1] = False
    return table


def check_tagged(got, want, tags, what):
    """Min-family lanes exactly, add-family lanes within rtol 1e-5."""
    check(torch.equal(got[~tags], want[~tags]),
          f"{what}: min-family lanes exact")
    if got.dtype.is_floating_point:
        check(torch.allclose(got[tags], want[tags], rtol=1e-5, atol=0.0),
              f"{what}: add-family lanes within rtol 1e-5")
    else:
        check(torch.equal(got[tags], want[tags]),
              f"{what}: add-family lanes exact")


def pagerank_stream(g):
    """PageRank's reorder input on ``g``: every edge's destination in CSR
    order, carrying ``rank[src] / deg[src]`` at the uniform start rank."""
    deg = g.degrees().clamp(min=1).float()
    return g.col_idx, (1.0 / g.n_nodes / deg)[g.edge_sources().long()]


def phase_hash_kernel(g, ef, gen):
    """B3 against its plain version (``kernels=False``) at full size."""
    from repro_torch.kernels.iru_reorder import ops as hash_ops

    dev = g.device
    pr_idx, pr_vals = pagerank_stream(g)
    lanes = ef.dsts.numel()
    depth = torch.randint(0, 64, (lanes,), generator=gen, device=dev,
                          dtype=torch.int32)               # BFS-like payload
    relax = torch.rand(lanes, generator=gen, device=dev) * 64  # SSSP-like
    hot = 1 << 20  # eight 32-index blocks: at most eight busy sets
    hot_idx = (torch.randint(0, 8, (hot,), generator=gen, device=dev)
               * 4096 + torch.randint(0, 32, (hot,), generator=gen,
                                      device=dev)).to(torch.int32)
    hot_vals = torch.rand(hot, generator=gen, device=dev)
    cases = [("pagerank add", pr_idx, pr_vals, "add", None),
             ("expansion min int32", ef.dsts, depth, "min", ef.n_valid),
             ("expansion min f32", ef.dsts, relax, "min", ef.n_valid),
             ("expansion no merge", ef.dsts, relax, None, ef.n_valid),
             ("eight hot sets max", hot_idx, hot_vals, "max", None)]
    herr = 0.0
    for label, idx, vals, op, n_live in cases:
        got = hash_ops.hash_reorder(idx, vals, filter_op=op, n_live=n_live)
        want = hash_ops.hash_reorder(idx, vals, filter_op=op, n_live=n_live,
                                     kernels=False)
        torch.cuda.synchronize()
        for field in ("indices", "positions", "active"):
            check(torch.equal(getattr(got, field), getattr(want, field)),
                  f"B3 {label}: {field} equal to plain")
        if op == "add":
            check(torch.allclose(got.secondary, want.secondary, rtol=1e-5,
                                 atol=0.0), f"B3 {label} within rtol 1e-5")
        else:
            check(torch.equal(got.secondary, want.secondary),
                  f"B3 {label} exact")
        err = (got.secondary.double() - want.secondary.double()).abs().max()
        herr = max(herr, err.item())
        live = idx.numel() if n_live is None else int(n_live)
        print(f"B3 {label:20s}: {idx.numel()} lanes ({live} live), "
              f"{int(got.active.sum())} survivors, max abs err "
              f"{err.item():.3g}, matches plain")
    # B3's tagged fold on the PageRank stream, each lane's family from the
    # per-node table; one plain call (it peels about a thousand rounds)
    table = family_table(g)
    got = hash_ops.hash_reorder(pr_idx, pr_vals, filter_op="tagged",
                                tag_table=table)
    want = hash_ops.hash_reorder(pr_idx, pr_vals, filter_op="tagged",
                                 tag_table=table, kernels=False)
    torch.cuda.synchronize()
    for field in ("indices", "positions", "active"):
        check(torch.equal(getattr(got, field), getattr(want, field)),
              f"B3 tagged: {field} equal to plain")
    check_tagged(got.secondary, want.secondary, table[got.indices.long()],
                 "B3 tagged")
    terr = (got.secondary.double() - want.secondary.double()).abs().max()
    print(f"B3 tagged pagerank   : {pr_idx.numel()} lanes, "
          f"{int(got.active.sum())} survivors, max abs err {terr.item():.3g},"
          f" matches plain")
    return herr, terr.item()


def host_oracle(cache: dict, name: str, gname: str, g, iters=None):
    """The host (numpy) oracle of app ``name`` on graph ``gname``, computed
    once a run (PageRank at ``iters`` iterations) and kept in ``cache``."""
    from repro_torch.apps import bfs, pagerank, sssp

    key = (name, gname, iters)
    if key not in cache:
        cache[key] = (pagerank(g, iters=iters) if name == "pagerank"
                      else {"bfs": bfs, "sssp": sssp}[name](g, 0))
    return torch.from_numpy(cache[key]).to(g.device)


# the plain hash engine peels about a thousand occupancy rounds a call at
# PageRank's shape and its SSSP on delaunay-1024 runs 1478 rounds: their
# plain-path comparison is cut to these depths (the kernel path runs the
# same depth for it, and in full against the host oracle)
PLAIN_DEPTH = {("hash", "pagerank", "kron20"): 5,
               ("hash", "sssp", "delaunay1024"): 300}


def phase_apps(graphs, oracles):
    from repro_torch.apps.bfs import BFS_APP
    from repro_torch.apps.pagerank import pagerank_app
    from repro_torch.apps.sssp import SSSP_APP
    from repro_torch.core import CapacityPolicy, FrontierPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts

    policy = CapacityPolicy(n_buckets=3)
    path = {"sort": ("coalesced_gather", "segment_merge"),
            "hash": ("coalesced_gather", "iru_reorder")}
    runs = [(mode, name, gname, app)
            for mode in ("sort", "hash")
            for name, gname, app in (
                ("bfs", "kron20", BFS_APP),
                ("sssp", "kron20", SSSP_APP),
                ("bfs", "delaunay1024", BFS_APP),
                ("sssp", "delaunay1024", SSSP_APP),
                ("pagerank", "kron20", None))]
    # warm-up: first launches load the libraries and CUDA modules
    for mode in path:
        FrontierPipeline(graphs["kron20"], BFS_APP, mode=mode,
                         capacity_policy=policy, max_iters=2).run(0)
    totals = {"coalesced_gather": 0, "segment_merge": 0, "iru_reorder": 0}
    for mode, name, gname, app in runs:
        g = graphs[gname]
        iters = None
        if name == "pagerank":
            iters = 20
            app = pagerank_app(iters)
        kernel_pipe = FrontierPipeline(g, app, mode=mode,
                                       capacity_policy=policy,
                                       max_iters=iters)
        reset_launch_counts()
        got, t_kernel = wall_s(lambda: kernel_pipe.run(0))
        counts = {k: launch_counts[k] for k in totals}
        for k in path[mode]:
            check(counts[k] > 0, f"{mode} {name} on {gname} launched {k}")
        for k, v in counts.items():
            totals[k] += v
        depth = PLAIN_DEPTH.get((mode, name, gname))
        plain_pipe = FrontierPipeline(g, app, mode=mode,
                                      capacity_policy=policy,
                                      max_iters=depth or iters, kernels=False)
        want, t_plain = wall_s(lambda: plain_pipe.run(0))
        mine = got
        if depth:  # the kernel path at the plain path's depth
            mine = FrontierPipeline(g, app, mode=mode, capacity_policy=policy,
                                    max_iters=depth).run(0)
        host = host_oracle(oracles, name, gname, g, iters)
        if name == "pagerank":
            check(torch.allclose(mine, want, rtol=1e-5, atol=0.0),
                  f"{mode} pagerank kernel path within rtol 1e-5 of the "
                  f"plain path")
            check(torch.allclose(got, host, rtol=1e-4, atol=0.0),
                  f"{mode} pagerank within rtol 1e-4 of the host oracle")
            check(bool(torch.isfinite(got).all()), "finite ranks")
        else:
            check(torch.equal(mine, want),
                  f"{mode} {name} equals the plain path")
            check(torch.equal(got, host),
                  f"{mode} {name} equals the host oracle")
        edges = g.n_edges * (iters if name == "pagerank" else 1)
        print(f"app {mode} {name:8s} {gname:12s}"
              f"{f' ({iters} iterations)' if iters else ''}: kernel path "
              f"{t_kernel:.3f} s ({edges / t_kernel:.4g} edges/s), plain "
              f"path {t_plain:.3f} s"
              f"{f' (first {depth} iterations)' if depth else ''}, launches "
              f"{counts}, {kernel_pipe.n_hops} bucket hops, host oracle "
              f"agrees")
    return totals


# The paper's evaluation at the size users run: each generator at the size
# of the graph it imitates (a name: that graph of make_graphs).
FULL_SIZE = (("ca", dict(scale=1024), "roadNet-CA"),
             ("cond", dict(n=40_000), "cond-mat-2005"),
             ("delaunay", "delaunay1024", "delaunay_n20"),
             ("human", dict(n=22_000), "human_gene1"),
             ("kron", "kron20", "kron_g500-logn20"),
             ("msdoor", dict(scale=75), "msdoor"))
FIG_ROWS = {  # figure module -> the per-cell keys it prints
    "fig4_overhead": ("iru_service_frac", "normalized_total"),
    "fig11_accesses": ("l1_ratio", "l2_ratio"),
    "fig12_noc": ("noc_ratio",),
    "fig13_perf_energy": ("speedup", "energy_ratio"),
    "fig14_coalescing": ("baseline_acc_per_warp", "iru_acc_per_warp",
                         "improvement"),
    "fig15_filter": ("filtered_frac",),
}


def same_trace(got, want) -> bool:
    """Two TraceRecorders hold the same events and IRU element count."""
    if got.iru_elements != want.iru_elements or len(got.events) != len(
            want.events):
        return False
    for (gi, ga, gat), (wi, wa, wat) in zip(got.events, want.events):
        if not (gi.dtype == wi.dtype and np.array_equal(gi, wi)
                and np.array_equal(ga, wa) and gat == wat):
            return False
    return True


def figures_at_harness_scale(dev):
    """Part (a): all 18 cells of the figure harness (DATASET_KW) with the IRU
    traces taken through kernel B3's windowed body (engine="hash"), each
    held against the same cell through the numpy oracle (engine="hash_ref"),
    then the six figures' rows.  Returns the launch counts."""
    import importlib
    import tempfile

    from repro_torch.apps.trace import TraceRecorder
    from repro_torch.figures import common
    from repro_torch.kernels import launch_counts, reset_launch_counts

    totals = {}
    t0 = time.perf_counter()
    for algo in common.ALGOS:
        for ds in common.DATASET_KW:
            g = common.make_dataset(ds, device=dev, **common.dataset_kw(ds))
            rec, ref = TraceRecorder(), TraceRecorder()
            reset_launch_counts()
            got, secs = wall_s(lambda: common._run(algo, g, "iru", rec,
                                                   engine="hash", device=dev))
            counts = dict(launch_counts)
            want = common._run(algo, g, "iru", ref, engine="hash_ref",
                               device=dev)
            check(counts.get("iru_reorder_windowed", 0) == len(rec.events),
                  f"figure cell {algo}/{ds}: one B3 windowed launch a "
                  f"reorder ({counts} for {len(rec.events)} events)")
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            check(same_trace(rec, ref), f"figure cell {algo}/{ds}: the B3 "
                  f"trace equals the oracle's (events, active, atomic, "
                  f"iru_elements)")
            note = "equal"
            if algo == "pr" and not np.array_equal(got.view(np.int32),
                                                   want.view(np.int32)):
                diff = float(np.abs(got.astype(np.float64) - want).max())
                note = f"max abs diff {diff:.3g} (rtol 1e-6)"
                check(np.allclose(got, want, rtol=1e-6, atol=0.0),
                      f"figure cell pr/{ds}: within rtol 1e-6 of the oracle")
            elif algo != "pr":
                check(np.array_equal(got, want),
                      f"figure cell {algo}/{ds}: result equals the oracle's")
            lanes = sum(len(i) for i, _, _ in rec.events)
            print(f"figure cell {algo:4s} {ds:8s}: {g.n_nodes} nodes, "
                  f"{g.n_edges} edges; B3 trace {len(rec.events)} events, "
                  f"{lanes} lanes, {secs:.3f} s, launches {counts}; equal "
                  f"to the hash_ref trace, result {note}")
    t_traces = time.perf_counter() - t0
    kept = common.RESULTS
    with tempfile.TemporaryDirectory() as cache:
        common.RESULTS = cache  # a fresh cache: every cell runs on the card
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            rows = {fig: importlib.import_module(
                f"repro_torch.figures.{fig}").run(engine="hash", device=dev)
                for fig in FIG_ROWS}
        finally:
            common.RESULTS = kept
        t_rows = time.perf_counter() - t0
    for k, v in launch_counts.items():
        totals[k] = totals.get(k, 0) + v
    check(launch_counts.get("iru_reorder_windowed", 0) > 0,
          "the figure drivers' IRU traces launched B3's windowed body")
    cells = {}
    for fig, keys in FIG_ROWS.items():
        for r in rows[fig]:
            if not r["algo"].startswith("MEAN"):
                cells.setdefault((r["algo"], r["dataset"]), []).append(
                    f"{fig.split('_')[0]} " + " ".join(
                        f"{k} {r[k]}" for k in keys))
    for (algo, ds), parts in cells.items():
        print(f"figure row {algo:4s} {ds:8s}: " + "; ".join(parts))
    for fig, keys in FIG_ROWS.items():
        for r in rows[fig]:
            if r["algo"].startswith("MEAN"):
                print(f"figure {fig} {r['algo']}: " + ", ".join(
                    f"{k} {r[k]}" for k in keys))
    print(f"figures (a): cost-model counts of a GTX 980 model over traces "
          f"taken on this card, not measurements of it; traces and oracle "
          f"checks {t_traces:.1f} s, the six drivers {t_rows:.1f} s")
    return totals


class CountingRecorder:
    """A TraceRecorder that reduces each event on the card as it arrives
    (Fig. 14's requests and warps, Fig. 15's lanes and active lanes) and
    drops it: a full-size trace kept whole would not fit the host."""

    def __init__(self):
        self.requests = self.warps = self.lanes = self.active = 0
        self.events = self.iru_elements = 0

    def access(self, indices, active=None, atomic: bool = False) -> None:
        from repro_torch.core.coalescing import accesses_per_group

        per = accesses_per_group(indices, active)
        act = (torch.ones_like(indices, dtype=torch.bool) if active is None
               else active)
        req, warps, live = torch.stack([per.sum(), (per > 0).sum(),
                                        act.sum()]).tolist()
        self.requests += req
        self.warps += warps
        self.active += live
        self.lanes += indices.numel()
        self.events += 1

    def processed(self, n: int) -> None:
        self.iru_elements += int(n)

    @property
    def per_warp(self) -> float:
        return self.requests / max(self.warps, 1)


def figures_at_full_size(graphs, oracles, dev):
    """Part (b): Figs. 14 and 15 on the six datasets at the size of the
    graphs they imitate, traced through FrontierPipeline.run_instrumented
    (B1, and with IRU_HASH B3's windowed body) and counted on the card.
    Returns the launch counts."""
    from repro_torch.apps.bfs import BFS_APP
    from repro_torch.apps.pagerank import pagerank_app
    from repro_torch.apps.sssp import SSSP_APP
    from repro_torch.core import CapacityPolicy, FrontierPipeline, IRUConfig
    from repro_torch.figures.common import geomean
    from repro_torch.graphs.generators import make_dataset
    from repro_torch.kernels import launch_counts, reset_launch_counts

    policy = CapacityPolicy(n_buckets=3)
    cfg = IRUConfig(**IRU_HASH)
    apps = (("bfs", lambda: BFS_APP, None), ("sssp", lambda: SSSP_APP, None),
            ("pr", lambda: pagerank_app(5), 5))
    totals, improvement, filtered = {}, {}, {}
    for ds, kw, imitates in FULL_SIZE:
        t0 = time.perf_counter()
        own = isinstance(kw, str)
        g = graphs[kw] if own else make_dataset(ds, device=dev, **kw)
        t_gen = time.perf_counter() - t0
        for algo, app, iters in apps:
            recs, res, walls, launched = {}, {}, {}, {}
            for mode in ("baseline", "hash"):
                pipe = FrontierPipeline(g, app(), mode=mode,
                                        iru_config=cfg if mode == "hash"
                                        else None, capacity_policy=policy,
                                        max_iters=iters, device=dev)
                rec = CountingRecorder()
                reset_launch_counts()
                res[mode], walls[mode] = wall_s(
                    lambda: pipe.run_instrumented(0, recorder=rec))
                counts = dict(launch_counts)
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v
                path = ("coalesced_gather",) + (
                    ("iru_reorder_windowed",) if mode == "hash" else ())
                for k in path:
                    check(counts.get(k, 0) >= rec.events,
                          f"figure {algo}/{ds} {mode}: {k} launched at least "
                          f"once a step ({counts}, {rec.events} steps)")
                if mode == "hash":
                    check(counts.get("iru_reorder_windowed", 0) == rec.events,
                          f"figure {algo}/{ds}: one B3 windowed launch a step")
                    check(rec.iru_elements == rec.lanes,
                          f"figure {algo}/{ds}: iru_elements equals the "
                          f"steps' live edges")
                whole = pipe.run(0)
                if algo == "pr":
                    check(torch.allclose(res[mode], whole, rtol=1e-5,
                                         atol=0.0),
                          f"figure pr/{ds} {mode}: instrumented within rtol "
                          f"1e-5 of run()")
                else:
                    check(torch.equal(res[mode], whole),
                          f"figure {algo}/{ds} {mode}: instrumented equals "
                          f"run()")
                recs[mode], launched[mode] = rec, counts
            base, iru = recs["baseline"], recs["hash"]
            check(base.lanes == iru.lanes and base.events == iru.events,
                  f"figure {algo}/{ds}: the IRU trace has the baseline's "
                  f"steps and lanes")
            if algo == "pr":
                check(torch.allclose(res["hash"], res["baseline"], rtol=1e-5,
                                     atol=0.0),
                      f"figure pr/{ds}: hash within rtol 1e-5 of baseline")
            else:
                check(torch.equal(res["hash"], res["baseline"]),
                      f"figure {algo}/{ds}: hash equals baseline")
                if own:
                    host = host_oracle(oracles, algo, kw, g)
                    check(torch.equal(res["hash"], host),
                          f"figure {algo}/{ds}: equals the host oracle")
            imp = base.per_warp / max(iru.per_warp, 1e-9)
            frac = 1.0 - iru.active / max(iru.lanes, 1)
            improvement[algo, ds], filtered[algo, ds] = imp, frac
            print(f"figure full {algo:4s} {ds:8s} ({imitates}): "
                  f"{g.n_nodes} nodes, {g.n_edges} edges, {iru.events} "
                  f"iterations; accesses per warp baseline "
                  f"{base.per_warp:.4f}, IRU {iru.per_warp:.4f}, improvement"
                  f" {imp:.4f}, filtered {frac:.4f}; trace wall baseline "
                  f"{walls['baseline']:.3f} s, IRU {walls['hash']:.3f} s; "
                  f"launches baseline {launched['baseline']}, IRU "
                  f"{launched['hash']}"
                  + (f"; graph built in {t_gen:.1f} s" if algo == "bfs"
                     else ""))
    merged = [v for (a, _), v in improvement.items() if a != "bfs"]
    print(f"figure full fig14 MEAN: improvement geomean "
          f"{geomean(list(improvement.values())):.4f} over all 18 cells, "
          f"{geomean(merged):.4f} over SSSP and PageRank")
    print(f"figure full fig15 MEAN: filtered "
          f"{np.mean([v for (a, _), v in filtered.items() if a != 'bfs']):.4f}"
          f" over SSSP and PageRank")
    print("figures (b): measured from traces taken on this card; the "
          "pipeline's BFS merges duplicate destinations (filter_op='min'), "
          "the harness's host BFS does not, so (b)'s BFS rows are not "
          "comparable cell by cell with (a)'s")
    return totals


def phase_figures(graphs, oracles):
    """The paper's evaluation path: (a) the six figure drivers at their own
    scale with B3's traces held against the oracle's, (b) Figs. 14 and 15
    at full size through the instrumented pipeline, (c) the dense
    whole-run apps.  Returns the launch counts."""
    from repro_torch.apps.bfs import bfs_jit
    from repro_torch.apps.pagerank import pagerank_jit
    from repro_torch.kernels import launch_counts, reset_launch_counts

    dev = graphs["kron20"].device
    t0 = time.perf_counter()
    totals = figures_at_harness_scale(dev)
    t_a = time.perf_counter() - t0
    for k, v in figures_at_full_size(graphs, oracles, dev).items():
        totals[k] = totals.get(k, 0) + v
    t_b = time.perf_counter() - t0 - t_a
    for gname in ("kron20", "delaunay1024"):
        g = graphs[gname]
        label, secs = wall_s(lambda: bfs_jit(g, 0, device=dev))
        check(torch.equal(label, host_oracle(oracles, "bfs", gname, g)),
              f"bfs_jit on {gname} equals the host oracle")
        print(f"bfs_jit {gname}: {secs:.3f} s, equals the host oracle")
    g = graphs["kron20"]
    reset_launch_counts()
    rank, secs = wall_s(lambda: pagerank_jit(
        g.edge_sources(), g.col_idx, g.degrees(), g.n_nodes, iters=20,
        use_iru=True, device=dev))
    counts = dict(launch_counts)
    check(counts.get("segment_merge", 0) >= 20,
          f"pagerank_jit launched B2 once an iteration ({counts})")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    host = host_oracle(oracles, "pagerank", "kron20", g, 20)
    check(torch.allclose(rank, host, rtol=1e-4, atol=1e-7),
          "pagerank_jit (use_iru) within rtol 1e-4, atol 1e-7 of the host "
          "oracle")
    print(f"pagerank_jit kron20 (20 iterations, use_iru): {secs:.3f} s, "
          f"launches {counts}, max abs diff from the host oracle "
          f"{max_abs_err(rank, host):.3g}")
    print(f"phase figures: (a) {t_a:.1f} s, (b) {t_b:.1f} s, total "
          f"{time.perf_counter() - t0:.1f} s")
    return totals


SERVING_RUNS = (  # label, fused, mode, kernels, kernels the run must launch
    ("fused baseline", True, "baseline", True, ("coalesced_gather",)),
    ("fused sort", True, "sort", True,
     ("coalesced_gather", "segment_merge_tagged")),
    ("fused hash", True, "hash", True,
     ("coalesced_gather", "iru_reorder_tagged")),
    ("split hash", False, "hash", True, ("coalesced_gather", "iru_reorder")),
    ("fused sort plain", True, "sort", False, ()),
)


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| / |want| over the entries where want != 0."""
    nz = want != 0
    if not nz.any():
        return 0.0
    return float(np.max(np.abs(got[nz].astype(np.float64) - want[nz])
                        / np.abs(want[nz].astype(np.float64))))


def serving_queries(g):
    """The serving mix: 4 BFS, 4 SSSP and 4 PPR (20 iterations, damping
    0.85) from seeded sources of nonzero degree, interleaved."""
    from repro_torch.serve import GraphQuery

    nonzero = np.flatnonzero(g.degrees().cpu().numpy() > 0)
    srcs = np.random.default_rng(SEED).choice(nonzero, 12, replace=False)
    kinds = ("bfs", "sssp", "ppr") * 4
    return [GraphQuery(kind, int(src), iters=20, damping=0.85)
            for kind, src in zip(kinds, srcs)]


def serving_streams(view, g):
    """One extra fused sort run of the serving mix with the reorder stage
    wrapped (untimed, its launches not counted).  Of its top-rung ticks it
    keeps the one with the most live lanes (the sorted stream that B2's
    tagged body merged) and the one with the fewest (the expansion stream
    and ``n_live`` that B3's tagged fold takes in hash mode: B3's plain
    version takes time in proportion to live lanes times width)."""
    from repro_torch.core import filter as filt
    from repro_torch.core import pipeline
    from repro_torch.serve import GraphServeConfig, GraphServingEngine

    most, least = {"live": -1}, {"live": view.n_edges + 1}
    merged = {}
    reorder, merge = pipeline.iru_reorder, filt.merge_sorted

    def merge_spy(*args):
        merged["args"] = args
        return merge(*args)

    def reorder_spy(indices, secondary, **kw):
        out = reorder(indices, secondary, **kw)
        sorted_args, live = merged.pop("args"), int(kw["n_live"])
        if indices.numel() == view.n_edges:
            if live > most["live"]:
                most.update(live=live, stream=sorted_args)
            if live < least["live"]:
                least.update(live=live, stream=(
                    indices, secondary, kw["n_live"], kw["tag_table"]))
        return out

    pipeline.iru_reorder, filt.merge_sorted = reorder_spy, merge_spy
    try:
        eng = GraphServingEngine(view, GraphServeConfig(mode="sort"))
        for q in serving_queries(g):
            eng.submit(q)
        eng.run_to_completion(1000)
    finally:
        pipeline.iru_reorder, filt.merge_sorted = reorder, merge
    del eng
    check(most["live"] >= 0, "a serving tick ran at the top rung")
    return most, least


def max_abs_err(got, want) -> float:
    """Largest |got - want|, equal entries (infinities too) counting 0."""
    return torch.where(got == want, 0.0, got.double() - want.double()
                       ).abs().max().item()


def phase_serving_kernels(view, g):
    """B2's tagged body and B3's tagged fold on serving ticks at the top
    rung (8 m lanes), against their plain versions: the lane and offset
    arithmetic at the size the serving path runs."""
    from repro_torch.kernels.iru_reorder import ops as hash_ops
    from repro_torch.kernels.segment_merge import ops as merge_ops
    from repro_torch.kernels.segment_merge.ref import segment_merge_ref

    most, least = serving_streams(view, g)
    idx, vals, _, live_s, tags = most.pop("stream")
    lanes = idx.numel()
    got_v, got_s = merge_ops.segment_merge(idx, vals, op="tagged",
                                           active=live_s, tags=tags)
    want_v, want_s = segment_merge_ref(idx, vals, "tagged", live_s, tags)
    torch.cuda.synchronize()
    check_tagged(got_v, want_v, tags, "B2 tagged serving tick")
    check(torch.equal(got_s, want_s), "B2 tagged serving tick survivors")
    b2_err = max_abs_err(got_v, want_v)
    b2_ms = event_ms(lambda: merge_ops.segment_merge(
        idx, vals, op="tagged", active=live_s, tags=tags), reps=3)
    print(f"B2 tagged serving tick: {lanes} lanes ({most['live']} live), "
          f"{int(got_s.sum())} survivors, max abs err {b2_err:.3g}, matches "
          f"plain; kernel {b2_ms:.4f} ms")
    profile_window("B2 tagged on the serving tick, one call",
                   lambda: merge_ops.segment_merge(
                       idx, vals, op="tagged", active=live_s, tags=tags))
    del idx, vals, live_s, tags, got_v, got_s, want_v, want_s
    torch.cuda.empty_cache()
    idx, vals, n_live, table = least.pop("stream")
    got = hash_ops.hash_reorder(idx, vals, filter_op="tagged",
                                tag_table=table, n_live=n_live)
    b3_ms = event_ms(lambda: hash_ops.hash_reorder(
        idx, vals, filter_op="tagged", tag_table=table, n_live=n_live),
        reps=3)
    want, t_plain = wall_s(lambda: hash_ops.hash_reorder(
        idx, vals, filter_op="tagged", tag_table=table, n_live=n_live,
        kernels=False))
    for field in ("indices", "positions", "active"):
        check(torch.equal(getattr(got, field), getattr(want, field)),
              f"B3 tagged serving tick: {field} equal to plain")
    check_tagged(got.secondary, want.secondary, table[got.indices.long()],
                 "B3 tagged serving tick")
    b3_err = max_abs_err(got.secondary, want.secondary)
    print(f"B3 tagged serving tick: {lanes} lanes ({least['live']} live), "
          f"{int(got.active.sum())} survivors, max abs err {b3_err:.3g}, "
          f"matches plain; kernel {b3_ms:.4f} ms, plain {t_plain:.1f} s")
    return {"segment_merge_tagged": b2_err, "iru_reorder_tagged": b3_err}


def phase_serving(g):
    """Multi-tenant serving on tile_csr(kron-20, 8) in five runs (see the
    module docstring), then the tagged kernels on a serving tick's streams.
    Returns the launch counts summed over the five runs, the tagged
    kernels' largest errors there and the fused sort and hash runs'
    queries."""
    from repro_torch.apps import bfs, sssp
    from repro_torch.graphs.csr import tile_csr
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import GraphServeConfig, GraphServingEngine

    cfg = GraphServeConfig()
    view, t_tile = wall_s(lambda: tile_csr(g, cfg.query_slots))
    print(f"serving graph tile_csr(kron20, {cfg.query_slots}): "
          f"{view.n_nodes} nodes, {view.n_edges} edges, tiled in "
          f"{t_tile:.3f} s; edge budget {cfg.query_slots * g.n_edges} lanes")
    totals = {}
    results = {}
    for label, fused, mode, kernels, path in SERVING_RUNS:
        eng = GraphServingEngine(view, GraphServeConfig(
            fused=fused, mode=mode, kernels=kernels))
        qs = serving_queries(g)
        for q in qs:
            eng.submit(q)
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        _, wall = wall_s(lambda: eng.run_to_completion(1000))
        counts = dict(launch_counts)
        peak = torch.cuda.max_memory_allocated()
        for k in path:
            check(counts.get(k, 0) > 0, f"serving {label} launched {k}")
        if not kernels:
            check(not any(counts.values()),
                  f"serving {label} launched no kernel")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        for q in qs:
            check(q.status == "done", f"serving {label}: query {q.qid} "
                  f"({q.kind}) done, got {q.status} ({q.error})")
        print(f"serving {label:16s}: {len(qs)} queries in {wall:.3f} s "
              f"({len(qs) / wall:.4g} queries/s), {eng.tick_no} ticks, "
              f"{eng.overflow_events} overflow events, {eng.quarantines} "
              f"quarantines, launches {counts}, peak device memory "
              f"{peak / 2**30:.2f} GiB")
        if kernels:
            worst = 0.0
            for q in qs:
                solo = eng.solo_reference(q)
                if q.kind == "ppr":
                    worst = max(worst, rel_err(q.result, solo))
                    check(np.allclose(q.result, solo, rtol=1e-5, atol=0.0),
                          f"serving {label}: ppr {q.qid} within rtol 1e-5 "
                          f"of solo (max relative error "
                          f"{rel_err(q.result, solo):.3g})")
                else:
                    check(np.array_equal(q.result, solo),
                          f"serving {label}: {q.kind} {q.qid} equals solo")
            print(f"  BFS/SSSP equal their solo runs; PPR max relative error "
                  f"against solo {worst:.3g}")
        results[label] = qs
        del eng
        torch.cuda.empty_cache()
    for a, b in zip(results["fused sort"], results["fused sort plain"]):
        if a.kind == "ppr":
            print(f"  ppr {a.qid}: fused sort against its plain twin, max "
                  f"relative error {rel_err(a.result, b.result):.3g}")
            check(np.allclose(a.result, b.result, rtol=1e-5, atol=0.0),
                  f"serving ppr {a.qid}: kernels within rtol 1e-5 of plain")
        else:
            check(np.array_equal(a.result, b.result),
                  f"serving {a.kind} {a.qid}: kernels equal plain")
    qs = results["fused hash"]
    first_bfs = next(q for q in qs if q.kind == "bfs")
    first_sssp = next(q for q in qs if q.kind == "sssp")
    check(np.array_equal(first_bfs.result, bfs(g, first_bfs.source)),
          "serving bfs equals the host oracle")
    check(np.array_equal(first_sssp.result, sssp(g, first_sssp.source)),
          "serving sssp equals the host oracle")
    print("serving: every query done; BFS/SSSP equal solo runs (and the "
          "host oracles), PPR within rtol 1e-5 of solo; fused sort equals "
          "its plain twin")
    fused = {k: results[k] for k in ("fused sort", "fused hash")}
    del results, qs
    torch.cuda.empty_cache()
    errors = phase_serving_kernels(view, g)
    del view
    torch.cuda.empty_cache()
    return totals, errors, fused


# the kernels a partitioned run must launch on every shard, by mode
SHARD_PATH = {"baseline": ("coalesced_gather",),
              "sort": ("coalesced_gather", "segment_merge"),
              "hash": ("coalesced_gather", "iru_reorder"),
              "IRU_HASH": ("coalesced_gather", "iru_reorder_windowed"),
              "fused sort": ("coalesced_gather", "segment_merge_tagged"),
              "fused hash": ("coalesced_gather", "iru_reorder_tagged")}


class ShardLaunches:
    """Launch counts split by shard: wraps the partitioned superstep's
    per-shard ``frontier_scatter`` and charges each call's new launches to
    its shard (shards numbered in the order first seen)."""

    def __init__(self):
        from repro_torch.dist import graph_partition
        from repro_torch.kernels import launch_counts

        self.module, self.counts = graph_partition, launch_counts
        self.scatter = graph_partition.frontier_scatter
        self.shard: dict[int, int] = {}
        self.per_shard: list[dict] = []

    def __enter__(self):
        def spy(g, *args, **kw):
            before = dict(self.counts)
            out = self.scatter(g, *args, **kw)
            if id(g) not in self.shard:
                self.shard[id(g)] = len(self.per_shard)
                self.per_shard.append({})
            mine = self.per_shard[self.shard[id(g)]]
            for k, v in self.counts.items():
                if v != before.get(k, 0):
                    mine[k] = mine.get(k, 0) + v - before.get(k, 0)
            return out

        self.module.frontier_scatter = spy
        return self

    def __exit__(self, *exc):
        self.module.frontier_scatter = self.scatter

    def check(self, need, n_parts: int, what: str) -> list[dict]:
        check(len(self.per_shard) == n_parts,
              f"{what}: {len(self.per_shard)} of {n_parts} shards stepped")
        for p, counts in enumerate(self.per_shard):
            for k in need:
                check(counts.get(k, 0) > 0,
                      f"{what}: shard {p} launched {k}")
        return self.per_shard


def build_partition(g, n_parts: int, label: str):
    from repro_torch.graphs.csr import partition_csr

    out, t_build = wall_s(lambda: partition_csr(g, n_parts))
    part = getattr(out, "part", out)
    print(f"partition {label} P={n_parts}: built on the card in "
          f"{t_build:.3f} s, {part.nbytes() / 2**30:.3f} GiB on the device; "
          f"block {part.block}, ghost_cap {part.ghost_cap}, lane_cap "
          f"{part.lane_cap}, edge_cap {part.edge_cap}")
    return out


def phase_partitioned(graphs, oracles, served):
    """The edge-partitioned pipeline and partitioned serving, every shard on
    the card, stepped in turn (see the module docstring).  ``served`` maps
    phase 6's fused serving labels to their queries, the single-device
    results partitioned serving must equal.  Returns the launch counts."""
    from repro_torch.apps.bfs import BFS_APP
    from repro_torch.apps.pagerank import pagerank_app
    from repro_torch.apps.sssp import SSSP_APP
    from repro_torch.core import CapacityPolicy, FrontierPipeline, IRUConfig
    from repro_torch.dist import (PartitionedFrontierPipeline,
                                  partitioned_bfs_app,
                                  partitioned_pagerank_app,
                                  partitioned_sssp_app)
    from repro_torch.kernels import launch_counts, reset_launch_counts

    totals: dict = {}

    def count(what, shards, need, n_parts):
        counts = shards.check(need, n_parts, what)
        for k, v in launch_counts.items():
            totals[k] = totals.get(k, 0) + v
        return counts

    g = graphs["kron20"]
    part = build_partition(g, 4, "kron20")
    apps = {"bfs": (BFS_APP, partitioned_bfs_app, {}),
            "sssp": (SSSP_APP, partitioned_sssp_app, {}),
            "pagerank": (pagerank_app(20), partitioned_pagerank_app,
                         {"iters": 20})}
    runs = [(name, mode, compress) for name in apps
            for mode in ("baseline", "sort", "hash")
            for compress in (False, True)] + [("pagerank", "IRU_HASH", False)]
    single = {}
    for name, mode, compress in runs:
        app, make, kw = apps[name]
        cfg = IRUConfig(**IRU_HASH) if mode == "IRU_HASH" else None
        pmode = "hash" if mode == "IRU_HASH" else mode
        iters = kw.get("iters")
        if (name, mode) not in single:
            single[(name, mode)] = wall_s(lambda: FrontierPipeline(
                g, app, mode=pmode, iru_config=cfg, max_iters=iters).run(0))
        want, t_single = single[(name, mode)]
        pipe = PartitionedFrontierPipeline(
            part, make(part, **kw), mode=pmode, iru_config=cfg,
            compress=compress, max_iters=iters)
        reset_launch_counts()
        with ShardLaunches() as shards:
            got, wall = wall_s(lambda: pipe.run(0))
        what = (f"partitioned kron20 {name} {mode} compress={compress} "
                f"(codec {pipe.codec})")
        shard_counts = count(what, shards, SHARD_PATH[mode], 4)
        extra = ""
        if name == "pagerank":
            tol = 2e-3 if pipe.codec == "int8_ef" else 1e-4
            err = (got - want).abs()
            rel = rel_err(got.cpu().numpy(), want.cpu().numpy())
            l1 = (err.sum() / want.abs().sum()).item()
            check(torch.allclose(got, want, rtol=tol, atol=tol),
                  f"{what}: within rtol = atol = {tol} of single-device")
            if pipe.codec == "exact":
                check(torch.allclose(got, want, rtol=tol, atol=0.0),
                      f"{what}: within rtol {tol} (atol 0) of single-device")
            check(bool(torch.isfinite(got).all()), f"{what}: finite ranks")
            extra = (f"; against single-device max abs err "
                     f"{err.max().item():.3g}, max rel err {rel:.3g}, L1 "
                     f"rel err {l1:.3g} (mean rank {1 / g.n_nodes:.3g})")
        else:
            check(torch.equal(got, want), f"{what}: equals single-device")
            check(torch.equal(got, host_oracle(oracles, name, "kron20", g)),
                  f"{what}: equals the host oracle")
            extra = "; equals single-device and the host oracle"
        traffic = pipe.boundary_traffic()
        print(f"{what}: {pipe.supersteps} supersteps, {pipe.n_hops} hops, "
              f"{wall:.3f} s (single-device {t_single:.3f} s), boundary "
              f"raw {traffic['raw_bytes_per_superstep']} B / wire "
              f"{traffic['wire_bytes_per_superstep']} B per superstep, "
              f"launches per shard {shard_counts}{extra}")
    del single
    torch.cuda.empty_cache()

    # delaunay-1024: a thousand supersteps hopping the rungs
    gd = graphs["delaunay1024"]
    dpart = build_partition(gd, 4, "delaunay1024")
    policy = CapacityPolicy(n_buckets=3)
    want, t_single = wall_s(lambda: FrontierPipeline(
        gd, BFS_APP, mode="hash", capacity_policy=policy).run(0))
    pipe = PartitionedFrontierPipeline(
        dpart, partitioned_bfs_app(dpart), mode="hash", compress=True,
        capacity_policy=policy)
    reset_launch_counts()
    with ShardLaunches() as shards:
        got, wall = wall_s(lambda: pipe.run(0))
    what = "partitioned delaunay1024 bfs hash compress=True (codec flag)"
    shard_counts = count(what, shards, SHARD_PATH["hash"], 4)
    check(torch.equal(got, want), f"{what}: equals single-device")
    check(torch.equal(got, host_oracle(oracles, "bfs", "delaunay1024", gd)),
          f"{what}: equals the host oracle")
    check(pipe.n_hops > 1, f"{what}: hopped rungs ({pipe.n_hops} hops)")
    traffic = pipe.boundary_traffic()
    print(f"{what} (3-rung CapacityPolicy): {pipe.supersteps} supersteps, "
          f"{pipe.n_hops} hops, {wall:.3f} s (single-device "
          f"{t_single:.3f} s), boundary raw "
          f"{traffic['raw_bytes_per_superstep']} B / wire "
          f"{traffic['wire_bytes_per_superstep']} B per superstep, "
          f"launches per shard {shard_counts}; equals single-device and the "
          f"host oracle")
    del dpart, pipe, got, want
    torch.cuda.empty_cache()

    # P = 4 puts two whole tenants on each shard (no boundary lanes); P = 3
    # cuts tenants 2 and 5, so the tagged exchange runs as well
    from repro_torch.graphs.csr import tile_csr

    view = tile_csr(g, 8)
    for n_parts, labels in ((4, ("fused hash", "fused sort")),
                            (3, ("fused hash",))):
        pview = build_partition(view, n_parts, "tile_csr(kron20, 8)")
        for label in labels:
            for k, v in phase_partitioned_serving(
                    g, pview, label, served[label]).items():
                totals[k] = totals.get(k, 0) + v
        del pview
        torch.cuda.empty_cache()
    return totals


def phase_partitioned_serving(g, pview, label, solo_qs):
    """The 12-query mix through the engine on ``pview``, a partitioned
    ``tile_csr(kron-20, 8)``, held against phase 6's single-device run of
    the same fused mode (``solo_qs``).  Returns the run's launch counts."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import GraphServeConfig, GraphServingEngine

    n_parts = pview.n_parts
    eng = GraphServingEngine(pview, GraphServeConfig(
        mode=label.split()[-1]))
    qs = serving_queries(g)
    for q in qs:
        eng.submit(q)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with ShardLaunches() as shards:
        _, wall = wall_s(lambda: eng.run_to_completion(1000))
    what = f"partitioned serving {label} P={n_parts}"
    shard_counts = shards.check(SHARD_PATH[label], n_parts, what)
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    worst = 0.0
    for q, solo in zip(qs, solo_qs):
        check(q.status == "done", f"{what}: query {q.qid} ({q.kind}) done, "
              f"got {q.status} ({q.error})")
        if q.kind == "ppr":
            worst = max(worst, rel_err(q.result, solo.result))
            check(np.allclose(q.result, solo.result, rtol=1e-5, atol=0.0),
                  f"{what}: ppr {q.qid} within rtol 1e-5 of single-device "
                  f"(max relative error {rel_err(q.result, solo.result):.3g})")
        else:
            check(np.array_equal(q.result, solo.result),
                  f"{what}: {q.kind} {q.qid} equals single-device")
    print(f"{what}: {len(qs)} queries in {wall:.3f} s ({len(qs) / wall:.4g} "
          f"queries/s), {eng.tick_no} ticks, {eng.overflow_events} overflow "
          f"events, lane_cap {pview.part.lane_cap}, launches per shard "
          f"{shard_counts}, peak device memory {peak / 2**30:.2f} GiB; "
          f"BFS/SSSP equal single-device, PPR max relative error {worst:.3g}")
    del eng
    torch.cuda.empty_cache()
    return counts


# the paper's IRU geometry (benchmarks/common.py's IRU_HASH): 1024 x 32 sets
# over 4 partitions x 2 banks, 8192-lane windows, round cap 64
IRU_HASH = dict(num_sets=1024, slots=32, window_elems=8192, n_partitions=4,
                n_banks=2, round_cap=64)
FIELDS = ("indices", "secondary", "positions", "active")


def window_branches(idx: np.ndarray, n_live, geo=IRU_HASH):
    """How many windows bypass the banks and how many take the round-cap
    fallback in a partition, by the oracle's rules (host numpy)."""
    from repro_torch.kernels.iru_reorder.ref import hash_set

    w, sets_n, parts = geo["window_elems"], geo["num_sets"], geo["n_partitions"]
    n = idx.size
    windows = -(-n // w)
    lane = np.arange(n)
    live = lane < (n if n_live is None else int(n_live))
    sets = hash_set(idx // np.int32(32), sets_n)
    cnt = np.bincount((lane // w * sets_n + sets)[live],
                      minlength=windows * sets_n).reshape(windows, sets_n)
    m = cnt.sum(1)
    per = -(-m // parts)
    capacity = np.minimum(m, per + np.maximum(64, per // 4))
    by_part = cnt.reshape(windows, sets_n // parts, parts)  # set r*P + p
    bypass = by_part.sum(1).max(1) > capacity
    hot = cnt > geo["round_cap"] * geo["slots"]
    dense = np.where(bypass, hot.any(1),
                     hot.reshape(windows, sets_n // parts, parts).any(1)
                     .any(1))
    return int(bypass.sum()), int(dense.sum())


def hold_windowed(label, idx, vals, op, n_live=None):
    """B3's windowed body (IRU_HASH, one launch) against the numpy oracle
    on every window, bit for bit, and against the plain window loop
    (kernels=False) on the whole stream: exact but for f32 add (rtol 1e-5,
    another addition order).  Returns (max abs error against plain, the
    plain call's seconds, windows that bypass, windows that fall back)."""
    from repro_torch.core import iru

    cfg = iru.IRUConfig(mode="hash", filter_op=op, **IRU_HASH)
    got = iru.iru_reorder(idx, vals, config=cfg, n_live=n_live)
    torch.cuda.synchronize()
    idx_np, vals_np = idx.cpu().numpy(), vals.cpu().numpy()
    live = None if n_live is None else int(n_live)
    t0 = time.perf_counter()
    oracle = iru._hash_ref_host(idx_np, vals_np, cfg, live)
    t_oracle = time.perf_counter() - t0
    w = cfg.window_elems
    windows = -(-idx.numel() // w)
    bad = set()
    for k, field in enumerate(FIELDS):
        a = getattr(got, field).cpu().numpy()
        b = oracle[k]
        if a.dtype == np.float32:  # bit for bit
            a, b = a.view(np.int32), b.view(np.int32)
        bad |= set((np.flatnonzero(a != b) // w).tolist())
    check(not bad, f"{label}: equal to the numpy oracle on every window "
          f"({len(bad)} of {windows} differ, first {sorted(bad)[:5]})")
    want, t_plain = wall_s(lambda: iru.iru_reorder(
        idx, vals, config=cfg, n_live=n_live, kernels=False))
    for field in ("indices", "positions", "active"):
        check(torch.equal(getattr(got, field), getattr(want, field)),
              f"{label}: {field} equal to plain")
    err = max_abs_err(got.secondary, want.secondary)
    nz = want.secondary != 0
    rel = ((got.secondary[nz].double() - want.secondary[nz].double()).abs()
           / want.secondary[nz].double().abs()).max().item() if nz.any() \
        else 0.0
    if op == "add":
        check(torch.allclose(got.secondary, want.secondary, rtol=1e-5,
                             atol=0.0), f"{label}: add within rtol 1e-5")
    else:
        check(torch.equal(got.secondary, want.secondary),
              f"{label}: exact against plain")
    bypass, dense = window_branches(idx_np, n_live)
    print(f"B3 windowed {label:22s}: {idx.numel()} lanes "
          f"({idx.numel() if live is None else live} live), {windows} "
          f"windows, {bypass} bypass the banks, {dense} take the round-cap "
          f"fallback in a partition; {int(got.active.sum())} survivors; "
          f"equal to the numpy oracle on every window (oracle {t_oracle:.1f} "
          f"s); against plain max abs err {err:.3g}, max rel err {rel:.3g} "
          f"(plain {t_plain:.1f} s)")
    return err, t_plain, bypass, dense


def trip_streams(dev):
    """Two 1M-lane streams (seeded, last windows ragged): one whose windows
    put about 2200 arrivals in one set of one partition (past the round
    cap's 64 x 32, under the partition's capacity), one whose windows put
    45% of their lanes into one partition's sets (past its capacity, no set
    past the cap)."""
    from repro_torch.kernels.iru_reorder.ref import hash_set

    rng = np.random.default_rng(SEED)
    n = 1 << 20
    blocks = np.arange(1 << 16)
    bset = hash_set(blocks, 1024)

    def pick(pool):  # n indices of the blocks in pool
        return (pool[rng.integers(0, pool.size, n)] * 32
                + rng.integers(0, 32, n))

    hot = rng.random(n) < 2200 / 8192
    cap_idx = np.where(hot, pick(blocks[bset == 3][:4]),
                       pick(blocks[bset % 4 != 3]))
    heavy = rng.random(n) < 0.45
    bypass_idx = np.where(heavy, pick(blocks[bset % 4 == 0]),
                          pick(blocks[bset % 4 != 0]))
    vals = rng.uniform(0.0, 1.0, n).astype(np.float32)
    live = torch.tensor(n - 25810, dtype=torch.int32, device=dev)
    as_t = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)
    return as_t(cap_idx), as_t(bypass_idx), torch.from_numpy(vals).to(dev), \
        live


def phase_windowed(graphs, oracles):
    """The paper's geometry on the card: B3's windowed body and its banked
    whole-stream layout held against the numpy oracle and the plain
    versions, the apps through FrontierPipeline with IRU_HASH and the host
    entry point reorder_frontier (the launch counts zeroed before each run
    and read after it), then the two bodies' times and a profile.  Returns
    (launches, errors, timing rows)."""
    from repro_torch.apps.bfs import BFS_APP
    from repro_torch.apps.pagerank import pagerank_app
    from repro_torch.apps.sssp import SSSP_APP
    from repro_torch.core import CapacityPolicy, FrontierPipeline
    from repro_torch.core.iru import IRUConfig, reorder_frontier
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.iru_reorder import ops as hash_ops
    from repro_torch.kernels.iru_reorder.ref import (hash_reorder_ref_banked,
                                                     hash_set,
                                                     partition_capacity)

    g = graphs["kron20"]
    dev = g.device
    pr_idx, pr_vals = pagerank_stream(g)
    idx_np, vals_np = pr_idx.cpu().numpy(), pr_vals.cpu().numpy()
    n = pr_idx.numel()
    err_w, t_plain_w, _, _ = hold_windowed("pagerank add", pr_idx, pr_vals,
                                           "add")
    err_min, _, _, _ = hold_windowed("pagerank min", pr_idx, pr_vals, "min")
    cap_idx, bypass_idx, vals, live = trip_streams(dev)
    err_cap, _, _, dense = hold_windowed("round-cap trip add", cap_idx, vals,
                                         "add", live)
    err_by, _, bypass, _ = hold_windowed("bypass trip min", bypass_idx, vals,
                                         "min", live)
    check(dense > 0, "the round-cap trip stream takes the fallback")
    check(bypass > 0, "the bypass trip stream bypasses the banks")
    print(f"B3 windowed: {dense} windows took the round-cap fallback, "
          f"{bypass} bypassed the banks")

    # whole-stream B3, banked layout (4 partitions, no window)
    kw = dict(num_sets=1024, slots=32, n_partitions=4)
    got = hash_ops.hash_reorder(pr_idx, pr_vals, filter_op="add", **kw)
    want, t_plain_b = wall_s(lambda: hash_ops.hash_reorder(
        pr_idx, pr_vals, filter_op="add", kernels=False, **kw))
    for field in ("indices", "positions", "active"):
        check(torch.equal(getattr(got, field), getattr(want, field)),
              f"B3 banked: {field} equal to plain")
    check(torch.allclose(got.secondary, want.secondary, rtol=1e-5, atol=0.0),
          "B3 banked add within rtol 1e-5 of plain")
    err_b = max_abs_err(got.secondary, want.secondary)
    # the oracle's round peeling for add takes minutes of host time at this
    # size; without a merge it is a closed form, and the layout (banks,
    # bypass, partition-major emission) is the same
    got0 = hash_ops.hash_reorder(pr_idx, pr_vals, **kw)
    t0 = time.perf_counter()
    oracle0 = hash_reorder_ref_banked(idx_np, vals_np, **kw)
    t_oracle = time.perf_counter() - t0
    for k, field in enumerate(FIELDS):
        check(np.array_equal(getattr(got0, field).cpu().numpy(), oracle0[k]),
              f"B3 banked, no merge: {field} equal to the numpy oracle")
    counts = np.bincount(hash_set(idx_np // np.int32(32), 1024) % 4,
                         minlength=4)
    print(f"B3 banked pagerank add  : {n} lanes, partitions hold "
          f"{counts.tolist()} (capacity {partition_capacity(n, 4)}), "
          f"{int(got.active.sum())} survivors, max abs err {err_b:.3g} "
          f"against plain (plain {t_plain_b:.1f} s); without a merge equal "
          f"to hash_reorder_ref_banked (oracle {t_oracle:.1f} s)")

    # the main path: the apps with IRU_HASH, and reorder_frontier
    cfg = IRUConfig(mode="hash", **IRU_HASH)
    policy = CapacityPolicy(n_buckets=3)
    FrontierPipeline(g, BFS_APP, mode="hash", iru_config=cfg,
                     capacity_policy=policy, max_iters=2).run(0)  # warm-up
    totals = {}
    for gname in ("kron20", "delaunay1024"):
        gr = graphs[gname]
        for name, app, iters in (("bfs", BFS_APP, None),
                                 ("sssp", SSSP_APP, None),
                                 ("pagerank", pagerank_app(20), 20)):
            pipe = FrontierPipeline(gr, app, mode="hash", iru_config=cfg,
                                    capacity_policy=policy, max_iters=iters)
            reset_launch_counts()
            out, secs = wall_s(lambda: pipe.run(0))
            counts_run = dict(launch_counts)
            for k in ("coalesced_gather", "iru_reorder_windowed"):
                check(counts_run.get(k, 0) > 0,
                      f"IRU_HASH {name} on {gname} launched {k}")
            for k, v in counts_run.items():
                totals[k] = totals.get(k, 0) + v
            host = host_oracle(oracles, name, gname, gr, iters)
            if iters:
                check(torch.allclose(out, host, rtol=1e-4, atol=0.0),
                      f"IRU_HASH pagerank on {gname} within rtol 1e-4 of the "
                      f"host oracle")
            else:
                check(torch.equal(out, host),
                      f"IRU_HASH {name} on {gname} equals the host oracle")
            edges = gr.n_edges * (iters or 1)
            print(f"app IRU_HASH {name:8s} {gname:12s}"
                  f"{f' ({iters} iterations)' if iters else ''}: "
                  f"{secs:.3f} s ({edges / secs:.4g} edges/s), launches "
                  f"{counts_run}, {pipe.n_hops} bucket hops, host oracle "
                  f"agrees")
    for label, fcfg, key in (
            ("IRU_HASH", IRUConfig(mode="hash", filter_op="add", **IRU_HASH),
             "iru_reorder_windowed"),
            ("4 partitions, no window",
             IRUConfig(mode="hash", filter_op="add", n_partitions=4),
             "iru_reorder_banked")):
        reset_launch_counts()
        out, secs = wall_s(lambda: reorder_frontier(idx_np, vals_np,
                                                    config=fcfg))
        counts_run = dict(launch_counts)
        check(counts_run.get(key, 0) == 1,
              f"reorder_frontier ({label}) launched {key} once")
        check(isinstance(out[0], np.ndarray)
              and np.array_equal(np.sort(out[2]), np.arange(n)),
              f"reorder_frontier ({label}): numpy, a permutation")
        for k, v in counts_run.items():
            totals[k] = totals.get(k, 0) + v
        print(f"reorder_frontier {label}: {n} lanes in {secs:.3f} s (host "
              f"copies included), {int(out[3].sum())} survivors, launches "
              f"{counts_run}")

    # times at PageRank's shape: CUDA events, bound = bytes over 3.35 TB/s
    add_cfg = IRUConfig(mode="hash", filter_op="add", **IRU_HASH)
    from repro_torch.core.iru import iru_reorder

    nbytes = n * (4 + 4) + n * (4 + 4 + 4 + 1)
    rows = {
        "iru_reorder_windowed": {
            "ms": event_ms(lambda: iru_reorder(pr_idx, pr_vals,
                                               config=add_cfg)),
            "plain_ms": t_plain_w * 1e3, "library_ms": None,
            "bytes": nbytes},
        "iru_reorder_banked": {
            "ms": event_ms(lambda: hash_ops.hash_reorder(
                pr_idx, pr_vals, filter_op="add", **kw)),
            "plain_ms": t_plain_b * 1e3, "library_ms": None,
            "bytes": nbytes},
    }
    for name, row in rows.items():
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        print(f"time {name}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.1f} ms (one call), library none, bound "
              f"{row['bound_ms']:.4f} ms ({row['bytes']} bytes, {n} lanes)")
    # where the windowed body's time goes: the same stream by window size,
    # without a merge, and in one partition
    sweep = {f"w={w}": dict(IRU_HASH, window_elems=w, filter_op="add")
             for w in (1024, 2048, 4096)}
    sweep["no merge"] = dict(IRU_HASH)
    sweep["1 partition"] = dict(IRU_HASH, filter_op="add", n_partitions=1)
    parts = []
    for label, kw_v in sweep.items():
        cfg_v = IRUConfig(mode="hash", **kw_v)
        ms = event_ms(lambda: iru_reorder(pr_idx, pr_vals, config=cfg_v))
        parts.append(f"{label} {ms:.4f} ms")
    print("time iru_reorder_windowed by variant at pagerank's shape: "
          + ", ".join(parts))
    profile_window("B3 windowed at pagerank's shape, one call",
                   lambda: iru_reorder(pr_idx, pr_vals, config=add_cfg))
    profile_window("B3 banked at pagerank's shape, one call",
                   lambda: hash_ops.hash_reorder(pr_idx, pr_vals,
                                                 filter_op="add", **kw))
    errors = {"iru_reorder_windowed": max(err_w, err_min, err_cap, err_by),
              "iru_reorder_banked": err_b}
    return totals, errors, rows


def phase_timings(g, dsts, contrib, sparse):
    from repro_torch.kernels.coalesced_gather import ops as gather_ops
    from repro_torch.kernels.coalesced_gather.ref import coalesced_gather_ref
    from repro_torch.kernels.segment_merge import ops as merge_ops
    from repro_torch.kernels.segment_merge.ref import segment_merge_ref

    dev = g.device
    n = g.n_edges
    # B1 at PageRank's shape: the all-nodes expansion's offsets, D = 1
    eids = torch.arange(n, dtype=torch.int32, device=dev)
    b1 = {
        "ms": event_ms(lambda: gather_ops.csr_edge_gather(g.col_idx, eids)),
        "plain_ms": event_ms(lambda: coalesced_gather_ref(g.col_idx, eids)),
        "library_ms": event_ms(lambda: torch.index_select(g.col_idx, 0,
                                                          eids)),
        "gpu_setting_ms": event_ms(lambda: gather_ops.csr_edge_gather(
            g.col_idx, eids, group=256, window=256)),
        # indices in, rows out, and each table row the stream touches once
        "bytes": n * 4 + n * 4 + int(torch.unique(eids).numel()) * 4,
    }
    # B2 at PageRank's shape: the sorted full stream, f32 add, all live
    active = torch.ones(n, dtype=torch.bool, device=dev)
    b2 = {
        "ms": event_ms(lambda: merge_ops.segment_merge(dsts, contrib, op="add",
                                                       active=active)),
        "plain_ms": event_ms(lambda: segment_merge_ref(dsts, contrib, "add",
                                                       active)),
        "library_ms": event_ms(lambda: torch.zeros(
            g.n_nodes, device=dev).scatter_reduce_(
                0, dsts.long(), contrib, reduce="sum")),
        # idx 4 + vals 4 + active 1 read, merged 4 + survivor 1 written
        "bytes": n * (4 + 4 + 1) + n * (4 + 1),
    }
    # B3 at PageRank's shape: every edge's destination, f32 add, all live.
    # No single PyTorch call computes the IRU hash, so there is no library
    # time; the plain version peels about a thousand rounds, so one rep.
    from repro_torch.kernels.iru_reorder import ops as hash_ops

    pr_idx, pr_vals = pagerank_stream(g)
    b3 = {
        "ms": event_ms(lambda: hash_ops.hash_reorder(pr_idx, pr_vals,
                                                     filter_op="add")),
        "plain_ms": event_ms(lambda: hash_ops.hash_reorder(
            pr_idx, pr_vals, filter_op="add", kernels=False), reps=1),
        "library_ms": None,
        # idx 4 + vals 4 read; idx 4 + vals 4 + pos 4 + active 1 written
        "bytes": n * (4 + 4) + n * (4 + 4 + 4 + 1),
    }
    # the tagged bodies at the same shapes, tags from the per-node table.
    # No single PyTorch call computes either function.
    table = family_table(g)
    tags = table[dsts.long()]
    b2t = {
        "ms": event_ms(lambda: merge_ops.segment_merge(
            dsts, contrib, op="tagged", active=active, tags=tags)),
        "plain_ms": event_ms(lambda: segment_merge_ref(dsts, contrib,
                                                       "tagged", active,
                                                       tags)),
        "library_ms": None,
        # idx 4 + vals 4 + active 1 + tag 1 read, merged 4 + survivor 1
        "bytes": n * (4 + 4 + 1 + 1) + n * (4 + 1),
    }
    b3t = {
        "ms": event_ms(lambda: hash_ops.hash_reorder(
            pr_idx, pr_vals, filter_op="tagged", tag_table=table)),
        "plain_ms": event_ms(lambda: hash_ops.hash_reorder(
            pr_idx, pr_vals, filter_op="tagged", tag_table=table,
            kernels=False), reps=1),
        "library_ms": None,
        # B3's bytes and the tag table read once
        "bytes": n * (4 + 4) + table.numel() + n * (4 + 4 + 4 + 1),
    }
    # B1 at a BFS level's shape: the gappy quarter-node expansion, D = 1
    ns = sparse.numel()
    sparse_bytes = ns * 4 * 2 + int(torch.unique(sparse).numel()) * 4
    kernel_ms = event_ms(lambda: gather_ops.csr_edge_gather(g.col_idx, sparse))
    library_ms = event_ms(lambda: torch.index_select(g.col_idx, 0, sparse))
    print(f"time coalesced_gather at a BFS level's shape (a quarter of the "
          f"nodes, {ns} lanes): kernel {kernel_ms:.4f} ms, library "
          f"{library_ms:.4f} ms (index_select), bound "
          f"{sparse_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({sparse_bytes} "
          f"bytes)")
    rows = {"coalesced_gather": b1, "segment_merge": b2,
            "segment_merge_tagged": b2t, "iru_reorder": b3,
            "iru_reorder_tagged": b3t}
    for name, row in rows.items():
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        print(f"time {name}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {lib}, "
              f"bound {row['bound_ms']:.4f} ms ({row['bytes']} bytes, "
              f"{n} lanes)" + (f", group=window=256 "
                               f"{row['gpu_setting_ms']:.4f} ms"
                               if "gpu_setting_ms" in row else ""))
    return rows


def phase_profile(graphs, dsts, contrib):
    """Device time by kernel over short windows (torch.profiler over CUPTI),
    and the device's busy share of the window's wall time: PageRank on
    kron-20 in sort and hash mode, SSSP on delaunay-1024, and one B2 call
    (add and tagged) and one B3 call (add and tagged) at PageRank's shape,
    their kernels one by one.  Profiling adds host overhead, so the share is
    a lower bound."""
    from repro_torch.apps.pagerank import pagerank_app
    from repro_torch.apps.sssp import SSSP_APP
    from repro_torch.core import CapacityPolicy, FrontierPipeline
    from repro_torch.kernels.iru_reorder import ops as hash_ops
    from repro_torch.kernels.segment_merge import ops as merge_ops

    windows = []
    for label, mode, gname, app, iters in (
            ("pagerank kron20, 2 iterations", "sort", "kron20",
             pagerank_app(2), 2),
            ("pagerank kron20, 2 iterations", "hash", "kron20",
             pagerank_app(2), 2),
            ("sssp delaunay1024, first 200 rounds", "sort", "delaunay1024",
             SSSP_APP, 200)):
        pipe = FrontierPipeline(graphs[gname], app, mode=mode,
                                capacity_policy=CapacityPolicy(n_buckets=3),
                                max_iters=iters)
        windows.append((f"{mode} {label}", lambda pipe=pipe: pipe.run(0)))
    from repro_torch.graphs.csr import tile_csr
    from repro_torch.serve import GraphServeConfig, GraphServingEngine

    view = tile_csr(graphs["kron20"], GraphServeConfig().query_slots)
    for mode in ("sort", "hash"):
        def serve_ticks(mode=mode):
            eng = GraphServingEngine(view, GraphServeConfig(mode=mode))
            for q in serving_queries(graphs["kron20"]):
                eng.submit(q)
            for _ in range(3):
                eng.tick()
        windows.append((f"serving fused {mode}, first 3 ticks", serve_ticks))
    table = family_table(graphs["kron20"])
    tags = table[dsts.long()]
    windows.append(("B2 add at pagerank's shape, one call",
                    lambda: merge_ops.segment_merge(dsts, contrib, op="add")))
    windows.append(("B2 tagged at pagerank's shape, one call",
                    lambda: merge_ops.segment_merge(dsts, contrib,
                                                    op="tagged", tags=tags)))
    pr_idx, pr_vals = pagerank_stream(graphs["kron20"])
    windows.append(("B3 at pagerank's shape, one call",
                    lambda: hash_ops.hash_reorder(pr_idx, pr_vals,
                                                  filter_op="add")))
    windows.append(("B3 tagged at pagerank's shape, one call",
                    lambda: hash_ops.hash_reorder(pr_idx, pr_vals,
                                                  filter_op="tagged",
                                                  tag_table=table)))
    for label, fn in windows:
        profile_window(label, fn)


def profile_window(label, fn):
    """Print the device time by kernel of one call of ``fn`` (after a
    warm-up call) and the device's busy share of its wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()  # warm-up
    for _ in range(3):  # a session sometimes records no device event
        # the profiler's own warm-up step: without it the first kernels of
        # a session can go unrecorded
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            wall_s(fn)
            prof.step()  # the recorded step ends with the session
            _, wall = wall_s(fn)
        rows = []  # device-side events only (kernels, copies, memsets)
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
            # the step's own span is not device work
            if (e.device_type == DeviceType.CUDA and dev_us > 0
                    and not e.key.startswith("ProfilerStep")):
                rows.append((dev_us, e.count, e.key))
        if rows:
            break
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    share = busy_ms / (wall * 1e3)
    print(f"profile {label}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_ms:.3f} ms ({share:.3f} of wall)")
    for dev_us, count, key in rows[:8]:
        print(f"  {dev_us / 1e3:9.4f} ms  x{count:<6d} {key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    phase_build()
    graphs = make_graphs(dev)
    dsts, contrib, sparse, errors = phase_kernels(graphs["kron20"])
    oracles = {}
    win_launches, win_errors, win_rows = phase_windowed(graphs, oracles)
    launches = phase_apps(graphs, oracles)
    for k, v in phase_figures(graphs, oracles).items():
        launches[k] = launches.get(k, 0) + v
    served, serving_errors, fused = phase_serving(graphs["kron20"])
    for k, v in served.items():
        launches[k] = launches.get(k, 0) + v
    t_part = time.perf_counter()
    for k, v in phase_partitioned(graphs, oracles, fused).items():
        launches[k] = launches.get(k, 0) + v
    print(f"partitioned phase: {time.perf_counter() - t_part:.1f} s")
    del fused
    for k, v in serving_errors.items():
        errors[k] = max(errors[k], v)
    timings = phase_timings(graphs["kron20"], dsts, contrib, sparse)
    phase_profile(graphs, dsts, contrib)
    for k, v in win_launches.items():
        launches[k] = launches.get(k, 0) + v
    errors.update(win_errors)
    timings.update(win_rows)

    sources = {
        "coalesced_gather": (
            "src/repro_torch/kernels/coalesced_gather/coalesced_gather.cu",
            "src/repro/kernels/coalesced_gather/coalesced_gather.py:43"),
        "segment_merge": (  # _kernel, add/min/max
            "src/repro_torch/kernels/segment_merge/segment_merge.cu",
            "src/repro/kernels/segment_merge/segment_merge.py:43"),
        "segment_merge_tagged": (  # _kernel_tagged, the fused families
            "src/repro_torch/kernels/segment_merge/segment_merge.cu",
            "src/repro/kernels/segment_merge/segment_merge.py:74"),
        "iru_reorder": (
            "src/repro_torch/kernels/iru_reorder/iru_reorder.cu",
            "src/repro/kernels/iru_reorder/iru_reorder.py:168"),
        "iru_reorder_tagged": (  # B3's tagged fold (the batched engine's)
            "src/repro_torch/kernels/iru_reorder/iru_reorder.cu",
            "src/repro/kernels/iru_reorder/iru_reorder.py:168"),
        "iru_reorder_banked": (  # B3, the banked layout (banked.py's)
            "src/repro_torch/kernels/iru_reorder/iru_reorder.cu",
            "src/repro/kernels/iru_reorder/iru_reorder.py:168"),
        "iru_reorder_windowed": (  # B3's windowed body (the paper's geometry)
            "src/repro_torch/kernels/iru_reorder/iru_reorder.cu",
            "src/repro/kernels/iru_reorder/iru_reorder.py:168"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches.get(name, 0),
                "max_abs_err": errors[name], "ms": timings[name]["ms"],
                "plain_ms": timings[name]["plain_ms"],
                "bound_ms": timings[name]["bound_ms"], "bound_by": "bytes",
                "library_ms": timings[name]["library_ms"]}
               for name, (src, replaces) in sources.items()]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

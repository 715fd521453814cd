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
               and max, survivors and min/max exactly; B3 (IRU hash) on
               kron-20's PageRank destination stream (add, f32), a half-graph
               expansion stream with its live prefix (min on int32 and f32,
               and no merge) and a stream that hammers eight sets (max, many
               rounds): indices, positions, active and min/max exactly, add
               within rtol 1e-5;
  3. apps    -- BFS and SSSP from node 0 on kron-20 and delaunay-1024, and
               PageRank on kron-20, through the kernels (kernels=True,
               3-bucket CapacityPolicy), once with mode="sort" (B1, B2) and
               once with mode="hash" (B1, B3).  Each run is held against the
               same run through the plain path (kernels=False) -- exactly for
               BFS/SSSP, rtol 1e-5 for PageRank -- and against the port's
               numpy host oracle (PageRank at rtol 1e-4: the oracle sums each
               hub's ~1e5 contributions sequentially in f32).  PageRank runs
               20 iterations.  The launch counts of each run are zeroed before
               it and read after it; a kernel of the path with no launch
               fails the run;
  4. timings -- CUDA-event times after a warm-up for each kernel, its plain
               version and one library call computing the same function (B3
               has none), the bound (bytes over the card's 3.35 TB/s), at
               PageRank's shape; B1 also at a BFS level's shape (the gappy
               quarter-node expansion) beside index_select;
  5. profile -- device time by kernel and the device's busy share over short
               windows of PageRank on kron-20 (sort and hash) and SSSP on
               delaunay-1024, and B3's kernels in one call at PageRank's
               shape.

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
    herr = phase_hash_kernel(g, ef, gen)
    return dsts, contrib, sparse, {"coalesced_gather": gerr,
                                   "segment_merge": merr, "iru_reorder": herr}


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
    return herr


def phase_apps(graphs):
    from repro_torch.apps import bfs, pagerank, sssp
    from repro_torch.apps.bfs import BFS_APP
    from repro_torch.apps.pagerank import pagerank_app
    from repro_torch.apps.sssp import SSSP_APP
    from repro_torch.core import CapacityPolicy, FrontierPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts

    policy = CapacityPolicy(n_buckets=3)
    path = {"sort": ("coalesced_gather", "segment_merge"),
            "hash": ("coalesced_gather", "iru_reorder")}
    runs = [(mode, name, gname, app, oracle)
            for mode in ("sort", "hash")
            for name, gname, app, oracle in (
                ("bfs", "kron20", BFS_APP, bfs),
                ("sssp", "kron20", SSSP_APP, sssp),
                ("bfs", "delaunay1024", BFS_APP, bfs),
                ("sssp", "delaunay1024", SSSP_APP, sssp),
                ("pagerank", "kron20", None, pagerank))]
    # warm-up: first launches load the libraries and CUDA modules
    for mode in path:
        FrontierPipeline(graphs["kron20"], BFS_APP, mode=mode,
                         capacity_policy=policy, max_iters=2).run(0)
    totals = {"coalesced_gather": 0, "segment_merge": 0, "iru_reorder": 0}
    seconds = {}
    for mode, name, gname, app, oracle in runs:
        g = graphs[gname]
        iters = None
        if name == "pagerank":
            iters = 20
            app = pagerank_app(iters)
        kernel_pipe = FrontierPipeline(g, app, mode=mode,
                                       capacity_policy=policy,
                                       max_iters=iters)
        plain_pipe = FrontierPipeline(g, app, mode=mode,
                                      capacity_policy=policy,
                                      max_iters=iters, kernels=False)
        reset_launch_counts()
        got, t_kernel = wall_s(lambda: kernel_pipe.run(0))
        counts = {k: launch_counts[k] for k in totals}
        for k in path[mode]:
            check(counts[k] > 0, f"{mode} {name} on {gname} launched {k}")
        for k, v in counts.items():
            totals[k] += v
        want, t_plain = wall_s(lambda: plain_pipe.run(0))
        host = oracle(g, iters=iters) if name == "pagerank" else oracle(g, 0)
        host = torch.from_numpy(host).to(g.device)
        if name == "pagerank":
            check(torch.allclose(got, want, rtol=1e-5, atol=0.0),
                  f"{mode} pagerank kernel path within rtol 1e-5 of the "
                  f"plain path")
            check(torch.allclose(got, host, rtol=1e-4, atol=0.0),
                  f"{mode} pagerank within rtol 1e-4 of the host oracle")
            check(bool(torch.isfinite(got).all()), "finite ranks")
        else:
            check(torch.equal(got, want),
                  f"{mode} {name} equals the plain path")
            check(torch.equal(got, host),
                  f"{mode} {name} equals the host oracle")
        edges = g.n_edges * (iters if name == "pagerank" else 1)
        seconds[(mode, name, gname)] = (t_kernel, t_plain)
        print(f"app {mode} {name:8s} {gname:12s}"
              f"{f' ({iters} iterations)' if iters else ''}: kernel path "
              f"{t_kernel:.3f} s ({edges / t_kernel:.4g} edges/s), plain "
              f"path {t_plain:.3f} s, launches {counts}, "
              f"{kernel_pipe.n_hops} bucket hops, host oracle agrees")
    return totals


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
    rows = {"coalesced_gather": b1, "segment_merge": b2, "iru_reorder": b3}
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


def phase_profile(graphs):
    """Device time by kernel over short windows (torch.profiler over CUPTI),
    and the device's busy share of the window's wall time: PageRank on
    kron-20 in sort and hash mode, SSSP on delaunay-1024, and one B3 call at
    PageRank's shape (its kernels one by one).  Profiling adds host
    overhead, so the share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.apps.pagerank import pagerank_app
    from repro_torch.apps.sssp import SSSP_APP
    from repro_torch.core import CapacityPolicy, FrontierPipeline
    from repro_torch.kernels.iru_reorder import ops as hash_ops

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
    pr_idx, pr_vals = pagerank_stream(graphs["kron20"])
    windows.append(("B3 at pagerank's shape, one call",
                    lambda: hash_ops.hash_reorder(pr_idx, pr_vals,
                                                  filter_op="add")))
    for label, fn in windows:
        fn()  # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = wall_s(fn)
        rows = []  # device-side events only (kernels, copies, memsets)
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
            if e.device_type == DeviceType.CUDA and dev_us > 0:
                rows.append((dev_us, e.count, e.key))
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3
        share = busy_ms / (wall * 1e3)
        print(f"profile {label}: wall {wall * 1e3:.1f} ms, device busy "
              f"{busy_ms:.1f} ms ({share:.3f} of wall)")
        for dev_us, count, key in rows[:8]:
            print(f"  {dev_us / 1e3:9.3f} ms  x{count:<6d} {key[:100]}")


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
    launches = phase_apps(graphs)
    timings = phase_timings(graphs["kron20"], dsts, contrib, sparse)
    phase_profile(graphs)

    sources = {
        "coalesced_gather": (
            "src/repro_torch/kernels/coalesced_gather/coalesced_gather.cu",
            "src/repro/kernels/coalesced_gather/coalesced_gather.py:43"),
        "segment_merge": (
            "src/repro_torch/kernels/segment_merge/segment_merge.cu",
            "src/repro/kernels/segment_merge/segment_merge.py:120"),
        "iru_reorder": (
            "src/repro_torch/kernels/iru_reorder/iru_reorder.cu",
            "src/repro/kernels/iru_reorder/iru_reorder.py:168"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
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

#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on a CUDA card (an H100).

Run from the repo root with no arguments:  python3 chip_smoke.py

Phases, in order (any failure exits non-zero and prints no result line):
  1. build   -- compiles every kernel of the port (nvcc, sm_90a) into
               build/kernels/ and prints the seconds and each kernel's
               register / shared-memory report;
  2. kernels -- holds each kernel against its plain PyTorch version on the
               card at full size: B1 (block-reuse gather) on kron-20's edge
               arrays with a real expansion's monotone offsets and a shuffled
               stream, at (group, window) = (8, 128) and (256, 256), exactly;
               B2 (segment merge) on kron-20's sorted destination stream with
               an active prefix, for add (f32, rtol 1e-5), min (f32, int32)
               and max, survivors and min/max exactly;
  3. apps    -- BFS and SSSP from node 0 on kron-20 and delaunay-1024, and
               PageRank (20 iterations) on kron-20, through the kernels
               (kernels=True, mode="sort", 3-bucket CapacityPolicy).  Each
               run is held against the same run through the plain path
               (kernels=False: plain gather and merge) -- exactly for BFS/SSSP, rtol
               1e-5 for PageRank -- and against the port's numpy host oracle
               (PageRank at rtol 1e-4: the oracle sums each hub's ~1e5
               contributions sequentially in f32).  The launch counts of each
               run are zeroed before it and read after it; a kernel of the
               path with no launch fails the run;
  4. timings -- CUDA-event times after a warm-up for each kernel, its plain
               version and one library call computing the same function, the
               bound (bytes over the card's 3.35 TB/s), and host-clock times
               of each app run;
  5. profile -- device time by kernel and the device's busy share over a
               short window of PageRank on kron-20 and SSSP on delaunay-1024.

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
    # B1: a real expansion's offsets (half the nodes) and a shuffled stream
    mask = torch.rand(g.n_nodes, generator=gen, device=dev) < 0.5
    ef = expand_frontier(g, frontier_from_mask(mask), gather="torch")
    mono = ef.eids[:int(ef.n_valid)]
    shuffled = mono[torch.randperm(mono.numel(), generator=gen, device=dev)]
    gerr = 0.0
    for name, off in (("monotone", mono), ("shuffled", shuffled)):
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
    return dsts, contrib, {"coalesced_gather": gerr, "segment_merge": merr}


def phase_apps(graphs):
    from repro_torch.apps import bfs, pagerank, sssp
    from repro_torch.apps.bfs import BFS_APP
    from repro_torch.apps.pagerank import pagerank_app
    from repro_torch.apps.sssp import SSSP_APP
    from repro_torch.core import CapacityPolicy, FrontierPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts

    policy = CapacityPolicy(n_buckets=3)
    runs = [("bfs", "kron20", BFS_APP, bfs), ("sssp", "kron20", SSSP_APP, sssp),
            ("bfs", "delaunay1024", BFS_APP, bfs),
            ("sssp", "delaunay1024", SSSP_APP, sssp),
            ("pagerank", "kron20", pagerank_app(20), pagerank)]
    # warm-up: first launches load the libraries and CUDA modules
    FrontierPipeline(graphs["kron20"], BFS_APP, mode="sort",
                     capacity_policy=policy, max_iters=2).run(0)
    totals = {"coalesced_gather": 0, "segment_merge": 0}
    for name, gname, app, oracle in runs:
        g = graphs[gname]
        iters = 20 if name == "pagerank" else None
        kernel_pipe = FrontierPipeline(g, app, mode="sort",
                                       capacity_policy=policy,
                                       max_iters=iters)
        plain_pipe = FrontierPipeline(g, app, mode="sort",
                                      capacity_policy=policy,
                                      max_iters=iters, kernels=False)
        reset_launch_counts()
        got, t_kernel = wall_s(lambda: kernel_pipe.run(0))
        counts = {k: launch_counts[k] for k in totals}
        for k, v in counts.items():
            check(v > 0, f"{name} on {gname} launched {k}")
            totals[k] += v
        want, t_plain = wall_s(lambda: plain_pipe.run(0))
        host = oracle(g) if name == "pagerank" else oracle(g, 0)
        host = torch.from_numpy(host).to(g.device)
        if name == "pagerank":
            check(torch.allclose(got, want, rtol=1e-5, atol=0.0),
                  "pagerank kernel path within rtol 1e-5 of the plain path")
            check(torch.allclose(got, host, rtol=1e-4, atol=0.0),
                  "pagerank within rtol 1e-4 of the host oracle")
            check(bool(torch.isfinite(got).all()), "finite ranks")
        else:
            check(torch.equal(got, want), f"{name} equals the plain path")
            check(torch.equal(got, host), f"{name} equals the host oracle")
        edges = g.n_edges * (20 if name == "pagerank" else 1)
        print(f"app {name:8s} {gname:12s}: kernel path {t_kernel:.3f} s "
              f"({edges / t_kernel:.4g} edges/s), plain path {t_plain:.3f} s, "
              f"launches {counts}, {kernel_pipe.n_hops} bucket hops, host "
              f"oracle agrees")
    return totals


def phase_timings(g, dsts, contrib):
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
    for name, row in (("coalesced_gather", b1), ("segment_merge", b2)):
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        print(f"time {name}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bytes']} bytes, "
              f"{n} lanes)" + (f", group=window=256 "
                               f"{row['gpu_setting_ms']:.4f} ms"
                               if "gpu_setting_ms" in row else ""))
    return {"coalesced_gather": b1, "segment_merge": b2}


def phase_profile(graphs):
    """Device time by kernel over short windows of two runs (torch.profiler
    over CUPTI), and the device's busy share of the window's wall time.
    Profiling adds host overhead, so the share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.apps.pagerank import pagerank_app
    from repro_torch.apps.sssp import SSSP_APP
    from repro_torch.core import CapacityPolicy, FrontierPipeline

    for label, gname, app, iters in (
            ("pagerank kron20, 2 iterations", "kron20", pagerank_app(2), 2),
            ("sssp delaunay1024, first 200 rounds", "delaunay1024",
             SSSP_APP, 200)):
        pipe = FrontierPipeline(graphs[gname], app, mode="sort",
                                capacity_policy=CapacityPolicy(n_buckets=3),
                                max_iters=iters)
        pipe.run(0)  # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = wall_s(lambda: pipe.run(0))
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
    dsts, contrib, errors = phase_kernels(graphs["kron20"])
    launches = phase_apps(graphs)
    timings = phase_timings(graphs["kron20"], dsts, contrib)
    phase_profile(graphs)

    sources = {
        "coalesced_gather": (
            "src/repro_torch/kernels/coalesced_gather/coalesced_gather.cu",
            "src/repro/kernels/coalesced_gather/coalesced_gather.py:43"),
        "segment_merge": (
            "src/repro_torch/kernels/segment_merge/segment_merge.cu",
            "src/repro/kernels/segment_merge/segment_merge.py:120"),
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

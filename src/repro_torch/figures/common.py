"""Shared figure harness: BFS/SSSP/PageRank over the Table-3-like datasets
in baseline and IRU mode, collecting irregular-access traces for the GPU
cost model.

Counterpart of the reference's ``benchmarks/common.py``: the same datasets,
geometry, cells, counts and cache layout.  Where the reference's ``_run``
always reorders through the numpy oracle (``IRUConfig(mode="hash_ref")``),
the port takes an ``engine``:

* ``"hash"`` (default) -- ``reorder_frontier`` on ``device``: on the card,
  kernel B3's windowed body (one launch a level or iteration);
* ``"hash_ref"`` -- the numpy oracle on the host, which the card's traces
  are held against (and the engine of CPU runs).

Both give the same traces.  Results are cached under
``results/bench_torch/`` (never the reference's ``results/bench/``), one
file a cell and engine, so figure drivers compose without re-simulating;
pass ``force=True`` after changing app or trace semantics.  The cost
model's counts describe its GTX 980 model, whichever device took the trace.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.apps.bfs import bfs
from repro_torch.apps.pagerank import pagerank
from repro_torch.apps.sssp import sssp
from repro_torch.apps.trace import TraceRecorder
from repro_torch.core import coalescing
from repro_torch.core.costmodel import Comparison, TrafficCounts, simulate_trace
from repro_torch.core.iru import IRUConfig
from repro_torch.device import resolve_device
from repro_torch.graphs.generators import make_dataset

RESULTS = str(Path(__file__).resolve().parents[3] / "results" / "bench_torch")

# Table-3-like datasets at container scale (same connectivity regimes).
DATASET_KW = {
    "ca": dict(scale=96),
    "cond": dict(n=12_000),
    "delaunay": dict(scale=96),
    "human": dict(n=3_000),
    "kron": dict(scale=13),
    "msdoor": dict(scale=20),
}
# --quick: same connectivity regimes, frontier sizes capped for CI time.
QUICK_DATASET_KW = {
    "ca": dict(scale=32),
    "cond": dict(n=2_000),
    "delaunay": dict(scale=32),
    "human": dict(n=800),
    "kron": dict(scale=10),
    "msdoor": dict(scale=10),
}
ALGOS = ("bfs", "sssp", "pr")
ENGINES = ("hash", "hash_ref")

_QUICK = False


def set_quick(flag: bool) -> None:
    """Cap frontier sizes (and cache separately) for CI-time runs."""
    global _QUICK
    _QUICK = bool(flag)


def dataset_kw(name: str) -> dict:
    return (QUICK_DATASET_KW if _QUICK else DATASET_KW)[name]


# The IRU hash geometry of the paper: 1024 sets x 32 slots, 4 partitions x
# 2 banks (sets stripe as set % 4; each partition reorders its sub-stream
# on its own and emits partition-major).  round_cap bounds the occupancy
# round peeling on skewed frontiers (the dense fallback).  window_elems
# models the streaming lookahead: the hash drains under warp pressure, so
# the reorder scope is the in-flight window (~8k elements), not the
# frontier.
IRU_HASH = dict(num_sets=1024, slots=32, window_elems=8192,
                n_partitions=4, n_banks=2, round_cap=64)


def _run(algo: str, g, mode: str, recorder, *, engine: str = "hash",
         device: str | torch.device | None = None):
    """One app run of a cell (``mode`` "baseline" or "iru"), feeding
    ``recorder``; returns the app's result (the reference's returns
    nothing)."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    cfgs = {
        "bfs": IRUConfig(mode=engine, **IRU_HASH),
        "sssp": IRUConfig(mode=engine, filter_op="min", **IRU_HASH),
        "pr": IRUConfig(mode=engine, filter_op="add", **IRU_HASH),
    }
    kw = dict(mode=mode, recorder=recorder, device=device)
    if algo == "bfs":
        return bfs(g, 0, iru_config=cfgs["bfs"], **kw)
    if algo == "sssp":
        return sssp(g, 0, iru_config=cfgs["sssp"], **kw)
    return pagerank(g, iters=5, iru_config=cfgs["pr"], **kw)


def run_pair(algo: str, dataset: str, *, force: bool = False,
             engine: str = "hash",
             device: str | torch.device | None = None) -> dict:
    """Baseline + IRU traffic counts for one (algo, dataset) cell (cached).

    The graph is built on ``device`` (the card when None) and the IRU
    engine runs there; the host apps and the cost model run on the host.
    """
    suffix = "__quick" if _QUICK else ""
    path = os.path.join(RESULTS, f"{algo}__{dataset}__{engine}{suffix}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            out = json.load(f)
        # reports derive from counts at CURRENT GPUConfig constants
        base = TrafficCounts(**out["baseline"])
        iru = TrafficCounts(**out["iru"])
        out["report"] = Comparison(f"{algo}/{dataset}", base, iru).report()
        return out
    dev = resolve_device(device)
    g = make_dataset(dataset, device=dev, **dataset_kw(dataset))
    out = {"algo": algo, "dataset": dataset, "engine": engine,
           "n_nodes": g.n_nodes, "n_edges": g.n_edges}
    for mode in ("baseline", "iru"):
        rec = TraceRecorder()
        t0 = time.monotonic()
        _run(algo, g, mode, rec, engine=engine, device=dev)
        out[f"{mode}_wall_s"] = round(time.monotonic() - t0, 2)
        counts = simulate_trace(rec.events, iru_processed=rec.iru_elements)
        out[mode] = counts.__dict__
        # coalescing metric (Fig. 14): distinct 128B blocks per 32-lane
        # warp, counted on the run's device
        tot_req, tot_warps = 0, 0
        for idx, act, _ in rec.events:
            if len(idx) == 0:
                continue
            per = coalescing.accesses_per_group(
                torch.from_numpy(np.asarray(idx, np.int32)).to(dev),
                None if act is None else torch.from_numpy(act).to(dev))
            tot_req += int(per.sum())
            tot_warps += int((per > 0).sum())
        out[f"{mode}_accesses_per_warp"] = tot_req / max(tot_warps, 1)
        # filter effectiveness (Fig. 15)
        if mode == "iru":
            total = sum(len(i) for i, _, _ in rec.events)
            active = sum(int(np.count_nonzero(a)) if a is not None else len(i)
                         for i, a, _ in rec.events)
            out["filtered_frac"] = 1.0 - active / max(total, 1)
    base = TrafficCounts(**out["baseline"])
    iru = TrafficCounts(**out["iru"])
    out["report"] = Comparison(f"{algo}/{dataset}", base, iru).report()
    os.makedirs(RESULTS, exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def all_cells(force: bool = False, *, engine: str = "hash",
              device: str | torch.device | None = None):
    for algo in ALGOS:
        for ds in DATASET_KW:
            yield run_pair(algo, ds, force=force, engine=engine,
                           device=device)


def geomean(xs) -> float:
    xs = [x for x in xs if x > 0]
    return float(np.exp(np.mean(np.log(xs)))) if xs else float("nan")


def parse_args(argv=None) -> argparse.Namespace:
    """The figure drivers' command line; ``--quick`` calls ``set_quick``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized graphs (QUICK_DATASET_KW)")
    ap.add_argument("--force", action="store_true",
                    help="recompute cached cells")
    ap.add_argument("--engine", choices=ENGINES, default="hash",
                    help="IRU engine of the traces (hash: B3 on the card)")
    ap.add_argument("--device", default=None,
                    help="device of the graph and the engine (default: the "
                         "card; 'cpu' runs without one)")
    args = ap.parse_args(argv)
    if args.quick:
        set_quick(True)
    return args

"""Partitioned launcher: one graph shard (or block of bank partitions) per
rank of a ``torch.distributed`` process group.

The reference needs no launcher (one JAX process drives every device under
``shard_map``); the port runs one process a shard.  Two ways to start it:

* spawned here: the launcher builds the kernels once (on the card), then
  starts ``--nproc`` ranks of itself with ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set and a ``file://`` rendezvous
  (a fresh temporary file unless ``--init-method`` names one); a rank that
  fails stops the others, and the launcher exits with its code::

    PYTHONPATH=src python -m repro_torch.launch.partitioned --nproc 4 \\
        --backend gloo --device cpu --graph kron:7:8 --mode hash \\
        --app bfs:compress --app pagerank:iters=5:compress

* under ``torchrun`` (each process one rank, ``env://`` rendezvous); ranks
  never compile, so build first::

    python -m repro_torch.kernels._build
    torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.partitioned --backend gloo --graph kron:20:16 \\
        --mode hash --app bfs:compress

Every rank builds the graph (``--graph``: ``kron:SCALE:EDGE_FACTOR[:SEED]``
or an ``.npz`` of ``row_ptr``, ``col_idx`` and ``weights``) on its device.
The runs, each repeatable or combined in one launch:

* ``--app APP[:compress][:iters=N]``: ``PartitionedFrontierPipeline`` from
  source 0 over a group mesh on ``partition_csr(graph, world)``, each rank
  keeping its own shard;
* ``--serve FILE``: partitioned graph serving, ``GraphServingEngine`` over
  a group mesh on ``partition_csr(tile_csr(graph, slots), world)``.  FILE
  is a JSON object: ``queries`` (a list of ``{"kind", "source", "iters",
  "damping"}``), ``slots``, ``mode`` and, optionally, ``capacity_policy``
  (``[n_buckets, min_capacity, growth]``) and ``max_ticks``; its label is
  ``serve_<mode>``.  Every rank keeps the engine's global state and steps
  its own shard;
* ``--reorder SOURCE[:sets=N][:slots=N][:parts=N][:op=OP][:round_cap=N]
  [:live=N][:label=NAME]``: ``hash_reorder(..., n_partitions=parts,
  mesh=)``, the banked layout with one block of partitions a rank.
  SOURCE is ``pagerank`` (PageRank's first reorder on the graph: every
  edge's destination carrying ``rank[src] / deg[src]`` at the uniform
  start rank) or an ``.npz`` of ``indices`` and, optionally, ``secondary``
  and (read for ``op=tagged``) ``tag_table``;
* ``--moe DIR``: ``moe_hash_ep`` over the group (``DIR/config.json`` and
  the layer's ``router``, ``wi``, ``wg``, ``wo`` and ``x`` as ``.npy``;
  each rank reads its experts' rows alone), exact and int8-compressed;
* ``--allreduce FILE``: ``allreduce_int8`` over a ``[rows, ...]`` array, a
  block of rows a rank.

Each run goes twice, every rank starting together (the first warms up).
Rank 0 prints one summary line a run and, with ``--out DIR``, writes each
result as ``DIR/<label>.npy`` (a served query as ``<label>.q<i>``, a
reorder's fields as ``<label>.indices`` and so on) and every rank's record
to ``DIR/summary.json``.

The device is ``cuda:{LOCAL_RANK % device_count()}`` unless ``--device``
says otherwise (raising without a card), and the backend is the caller's:
gloo runs on the CPU and on the card (several ranks may share it); NCCL
needs a card a rank.  Every collective waits at most ``--timeout`` seconds.
"""
from __future__ import annotations

import argparse
import ctypes
import datetime
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import rank_device

MODULE = "repro_torch.launch.partitioned"
APPS = ("bfs", "sssp", "pagerank")


def _parser() -> argparse.ArgumentParser:
    # torchrun parses its own options out of the script's arguments by
    # prefix: no option here may start one of its names (--run: --run-path)
    ap = argparse.ArgumentParser(prog=f"python -m {MODULE}")
    ap.add_argument("--nproc", type=int, default=None,
                    help="start this many ranks here (else: be one rank, "
                         "from RANK and WORLD_SIZE)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--init-method", default=None,
                    help="rendezvous URL (default: a temporary file:// "
                         "when spawning, env:// under torchrun)")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="seconds a collective may wait")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:LOCAL_RANK)")
    ap.add_argument("--graph", default=None,
                    help="kron:SCALE:EDGE_FACTOR[:SEED] or an .npz of "
                         "row_ptr, col_idx, weights")
    ap.add_argument("--mode", choices=("baseline", "sort", "hash"),
                    default="baseline")
    ap.add_argument("--ladder", default=None,
                    help="CapacityPolicy N_BUCKETS,MIN_CAPACITY,GROWTH")
    ap.add_argument("--app", action="append", default=[],
                    help="APP[:compress][:iters=N], APP one of bfs, sssp, "
                         "pagerank; repeatable")
    ap.add_argument("--serve", action="append", default=[],
                    help="JSON of a serving run (queries, slots, mode); "
                         "repeatable")
    ap.add_argument("--reorder", action="append", default=[],
                    help="SOURCE[:sets=N][:slots=N][:parts=N][:op=OP]"
                         "[:round_cap=N][:live=N][:label=NAME], SOURCE "
                         "pagerank or an .npz; repeatable")
    ap.add_argument("--moe", default=None, help="directory of a MoE layer")
    ap.add_argument("--allreduce", default=None, help=".npy [rows, ...]")
    ap.add_argument("--out", default=None, help="directory for results")
    return ap


def parse_app(spec: str) -> dict:
    """``APP[:compress][:iters=N]`` -> its fields."""
    app, *opts = spec.split(":")
    if app not in APPS:
        raise ValueError(f"--app {spec!r}: app must be one of {APPS}")
    run = {"app": app, "compress": False, "iters": 20}
    for opt in opts:
        key, _, val = opt.partition("=")
        if opt == "compress":
            run["compress"] = True
        elif key == "iters" and val.isdigit():
            run["iters"] = int(val)
        else:
            raise ValueError(f"--app {spec!r}: unknown option {opt!r}")
    run["label"] = "_".join(
        [app] + (["compress"] if run["compress"] else [])
        + ([f"iters{run['iters']}"] if app == "pagerank" else []))
    return run


_REORDER_INTS = ("sets", "slots", "parts", "round_cap", "live")


def parse_reorder(spec: str, index: int = 0) -> dict:
    """``SOURCE[:key=value]...`` -> its fields (``label`` defaults to
    ``reorder<index>``)."""
    source, *opts = spec.split(":")
    if source != "pagerank" and not source.endswith(".npz"):
        raise ValueError(f"--reorder {spec!r}: SOURCE is pagerank or an .npz")
    run = {"source": source, "sets": 1024, "slots": 32, "parts": 4,
           "op": None, "round_cap": None, "live": None,
           "label": f"reorder{index}"}
    for opt in opts:
        key, _, val = opt.partition("=")
        if key in _REORDER_INTS and val.isdigit():
            run[key] = int(val)
        elif key in ("op", "label") and val:
            run[key] = val
        else:
            raise ValueError(f"--reorder {spec!r}: unknown option {opt!r}")
    return run


def load_graph(spec: str, device: torch.device):
    """The CSR graph ``spec`` names, on ``device``."""
    from repro_torch.convert import graph_from_numpy
    from repro_torch.graphs.generators import kron

    kind, *nums = spec.split(":")
    if kind == "kron" and len(nums) in (2, 3):
        return kron(*map(int, nums), device=device)
    if spec.endswith(".npz"):
        with np.load(spec) as z:
            return graph_from_numpy(z["row_ptr"], z["col_idx"], z["weights"],
                                    device)
    raise ValueError(f"--graph {spec!r}: kron:SCALE:EDGE_FACTOR[:SEED] or "
                     f"an .npz path")


# -- one rank -----------------------------------------------------------------

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _shapes(named: dict) -> dict:
    return {k: list(v.shape) for k, v in named.items()}


def _report(records: list, out, results: dict) -> None:
    """Every rank's records -> rank 0's summary lines and files."""
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, records)
    if dist.get_rank() != 0:
        return
    for i, rec in enumerate(everyone[0]):
        per_rank = [r[i] for r in everyone]
        print(f"{rec['label']}: {rec['summary']}; wall "
              f"{max(r['wall_s'] for r in per_rank):.4f} s (slowest rank; "
              f"its first run "
              f"{max(r['first_wall_s'] for r in per_rank):.4f} s); "
              f"launches per rank {[r['launches'] for r in per_rank]}"
              + (f"; bytes sent through all_to_all_single "
                 f"{sum(r['sent_bytes'] for r in per_rank)}"
                 if "sent_bytes" in rec else "")
              + (f"; partition bytes per rank "
                 f"{[r['partition_bytes'] for r in per_rank]}"
                 if "partition_bytes" in rec else ""), flush=True)
    if out is not None:
        out = Path(out)
        out.mkdir(parents=True, exist_ok=True)
        for label, value in results.items():
            np.save(out / f"{label}.npy", value.cpu().numpy())
        (out / "summary.json").write_text(json.dumps(everyone, indent=1))


def _timed(fn, dev):
    """Run ``fn`` twice, every rank starting together: returns the second
    run's output, its wall seconds and launch counts, and the first run's
    wall seconds (kernel loads, allocator and library warm-up)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    walls = []
    for _ in range(2):
        dist.barrier()
        reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        walls.append(time.perf_counter() - t0)
    return out, walls[1], dict(launch_counts), walls[0]


def run_graph(args, dev: torch.device, world: int, g):
    """Each ``--app`` over a group mesh; returns (records, results)."""
    from repro_torch.core import CapacityPolicy
    from repro_torch.dist import graph_partition as gp
    from repro_torch.graphs.csr import partition_csr
    from repro_torch.launch.mesh import make_graph_mesh

    mesh = make_graph_mesh(world, dev, group="world")
    policy = (CapacityPolicy(*map(int, args.ladder.split(",")))
              if args.ladder else None)
    t0 = time.perf_counter()
    # the whole partition goes when the rank's shard is cut from it
    shard = partition_csr(g, world).shard(dist.get_rank())
    _sync(dev)
    if dist.get_rank() == 0:
        print(f"rank 0 setup: graph partitioned in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    records, results = [], {}
    for spec in args.app:
        run = parse_app(spec)
        kw = {"iters": run["iters"]} if run["app"] == "pagerank" else {}

        def fresh_run():
            pipe = gp.PartitionedFrontierPipeline(
                shard, getattr(gp, f"partitioned_{run['app']}_app")(
                    shard, **kw),
                mesh=mesh, mode=args.mode, compress=run["compress"],
                capacity_policy=policy, max_iters=kw.get("iters"))
            return pipe, pipe.run(0)

        (pipe, result), wall, launches, first = _timed(fresh_run, dev)
        traffic = pipe.boundary_traffic()
        held = {f"part.{k}": getattr(pipe.part, k)
                for k in pipe.part._TENSORS}
        held.update({f"state.{k}": v for k, v in pipe._state.items()})
        held.update(degrees=pipe._degrees, ef=pipe._ef)
        records.append({
            "label": run["label"], "codec": pipe.codec,
            "supersteps": pipe.supersteps, "n_hops": pipe.n_hops,
            "traffic": traffic, "wall_s": wall, "first_wall_s": first,
            "launches": launches, "sent_bytes": pipe.shards.sent_bytes,
            "partition_bytes": pipe.part.nbytes(), "held": _shapes(held),
            "summary": (
                f"P={world} over {args.backend} on {dev}, mode {args.mode}, "
                f"codec {pipe.codec}: {pipe.supersteps} supersteps, "
                f"{pipe.n_hops} hops, wire "
                f"{traffic['wire_bytes_per_superstep']} B a superstep "
                f"(raw {traffic['raw_bytes_per_superstep']} B)")})
        results[run["label"]] = result
        del pipe
    return records, results


def run_serve(args, dev: torch.device, world: int, g):
    """Each ``--serve`` run: the fused engine over a group mesh, one shard
    of ``partition_csr(tile_csr(g, slots), world)`` a rank."""
    from repro_torch.core import CapacityPolicy
    from repro_torch.graphs.csr import partition_csr, tile_csr
    from repro_torch.launch.mesh import make_graph_mesh
    from repro_torch.serve import (GraphQuery, GraphServeConfig,
                                   GraphServingEngine)

    mesh = make_graph_mesh(world, dev, group="world")
    records, results = [], {}
    for path in args.serve:
        spec = json.loads(Path(path).read_text())
        Q, mode = spec["slots"], spec["mode"]
        label = f"serve_{mode}"
        kw = ({"capacity_policy": CapacityPolicy(*spec["capacity_policy"])}
              if "capacity_policy" in spec else {})
        cfg = GraphServeConfig(query_slots=Q, mode=mode, **kw)

        def serve():
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            eng = GraphServingEngine(partition_csr(tile_csr(g, Q), world),
                                     cfg, mesh=mesh)
            qs = [GraphQuery(q["kind"], int(q["source"]),
                             iters=q.get("iters", 20),
                             damping=q.get("damping", 0.85))
                  for q in spec["queries"]]
            for q in qs:
                eng.submit(q)
            eng.run_to_completion(spec.get("max_ticks", 10_000))
            return eng, qs

        (eng, qs), wall, launches, first = _timed(serve, dev)
        # the timed run's peak on the card (None on the CPU)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else None)
        for i, q in enumerate(qs):
            if q.status != "done":
                raise RuntimeError(f"{label}: query {i} ({q.kind} from "
                                   f"{q.source}) ended {q.status}: {q.error}")
            results[f"{label}.q{i}"] = torch.from_numpy(q.result)
        part = eng.part_view.part
        records.append({
            "label": label, "wall_s": wall, "first_wall_s": first,
            "launches": launches, "sent_bytes": eng.shards.sent_bytes,
            "partition_bytes": part.nbytes(), "ticks": eng.tick_no,
            "overflow_events": eng.overflow_events,
            "quarantines": eng.quarantines,
            "admission_blocked": eng.admission_blocked,
            "lane_cap": part.lane_cap, "peak_bytes": peak,
            "summary": (
                f"{len(qs)} queries on {Q} slots over {world} ranks "
                f"({args.backend}, {dev}), mode {mode}: {eng.tick_no} ticks, "
                f"lane_cap {part.lane_cap}, {eng.overflow_events} overflow "
                f"events, {eng.quarantines} quarantines")})
        del eng
    return records, results


def reorder_stream(run: dict, g, dev: torch.device):
    """``(indices, secondary, tag_table)`` of a ``--reorder`` run."""
    if run["source"] == "pagerank":
        deg = g.degrees().clamp(min=1).float()
        start = (1.0 / g.n_nodes / deg)[g.edge_sources().long()]
        return g.col_idx, start, None
    with np.load(run["source"]) as z:
        idx = torch.from_numpy(z["indices"]).to(dev)
        sec = (torch.from_numpy(z["secondary"]).to(dev)
               if "secondary" in z else None)
        tags = (torch.from_numpy(z["tag_table"]).to(dev)
                if run["op"] == "tagged" else None)
    return idx, sec, tags


def run_reorder(args, dev: torch.device, world: int, g):
    """Each ``--reorder`` run: ``hash_reorder`` over a group mesh, one
    block of bank partitions a rank."""
    from repro_torch.kernels.iru_reorder.ops import hash_reorder
    from repro_torch.launch.mesh import make_iru_mesh

    records, results = [], {}
    for i, spec in enumerate(args.reorder):
        run = parse_reorder(spec, i)
        mesh = make_iru_mesh(run["parts"], dev, group="world")
        idx, sec, tags = reorder_stream(run, g, dev)
        out, wall, launches, first = _timed(lambda: hash_reorder(
            idx, sec, num_sets=run["sets"], slots=run["slots"],
            filter_op=run["op"], round_cap=run["round_cap"],
            n_partitions=run["parts"], n_live=run["live"], tag_table=tags,
            mesh=mesh), dev)
        per = run["parts"] // world
        held = list(range(dist.get_rank() * per, (dist.get_rank() + 1) * per))
        label = run["label"]
        for field in out._fields:
            results[f"{label}.{field}"] = getattr(out, field)
        records.append({
            "label": label, "wall_s": wall, "first_wall_s": first,
            "launches": launches, "partitions": held,
            "summary": (
                f"hash_reorder of {idx.shape[0]} lanes from {run['source']} "
                f"({run['sets']} x {run['slots']}, op {run['op']}, "
                f"round_cap {run['round_cap']}, live {run['live']}) over "
                f"{world} ranks ({args.backend}, {dev}), {run['parts']} "
                f"partitions, {per} a rank")})
    return records, results


def run_moe(args, dev: torch.device, world: int):
    """``moe_hash_ep`` over the group, exact and int8-compressed."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_iru_mesh
    from repro_torch.moe.ep import moe_hash_ep, shard_experts

    src = Path(args.moe)
    cfg = json.loads((src / "config.json").read_text())
    moe = MoEConfig(**cfg["moe"])
    n_parts = cfg.get("n_partitions") or world
    mesh = make_iru_mesh(n_parts, dev, group="world")
    layer = {k: np.load(src / f"{k}.npy", mmap_mode="r")
             for k in ("router", "wi", "wg", "wo")
             if (src / f"{k}.npy").exists()}  # no wg: a gelu layer
    params = params_from_numpy(
        shard_experts(layer, moe, world, dist.get_rank(), n_parts), dev)
    x = torch.from_numpy(np.load(src / "x.npy")).to(dev)
    records, results = [], {}
    for compress in (False, True):
        label = "moe_int8" if compress else "moe_exact"
        (y, aux), wall, launches, first = _timed(lambda: moe_hash_ep(
            params, x, moe, cfg["ffn_type"], mesh=mesh,
            n_partitions=n_parts, compress=compress), dev)
        results[label], results[f"{label}_aux"] = y, aux
        records.append({
            "label": label, "wall_s": wall, "first_wall_s": first,
            "launches": launches,
            "held": _shapes(params),
            "summary": (f"moe_hash_ep over {world} ranks ({args.backend}, "
                        f"{dev}), {n_parts} partitions, T={x.shape[0]}, "
                        f"experts held {params['experts'].tolist()}")})
    return records, results


def run_allreduce(args, dev: torch.device, world: int):
    from repro_torch.dist.collectives import allreduce_int8
    from repro_torch.launch.mesh import make_iru_mesh

    x = np.load(args.allreduce)
    if x.shape[0] % world:
        raise ValueError(f"--allreduce: {x.shape[0]} rows over {world} ranks")
    per = x.shape[0] // world
    r = dist.get_rank()
    block = torch.from_numpy(x[r * per:(r + 1) * per]).to(dev)
    y, wall, launches, first = _timed(lambda: allreduce_int8(
        block, mesh=make_iru_mesh(world, dev, group="world")), dev)
    return [{"label": "allreduce", "wall_s": wall, "first_wall_s": first,
             "launches": launches,
             "summary": f"allreduce_int8 of {list(x.shape)} over {world} "
                        f"ranks, {per} rows a rank"}], {"allreduce": y}


def rank_main(args) -> None:
    dev = rank_device(args.device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        torch.cuda.set_device(dev)
        _build.require_built()
    t0 = time.perf_counter()
    dist.init_process_group(
        args.backend, init_method=args.init_method or "env://", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=args.timeout))
    if rank == 0:
        print(f"rank 0 setup: init_process_group({args.backend}) "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    try:
        g = None
        if args.graph is not None:
            t0 = time.perf_counter()
            g = load_graph(args.graph, dev)
            _sync(dev)
            if rank == 0:
                print(f"rank 0 setup: graph {args.graph} loaded in "
                      f"{time.perf_counter() - t0:.3f} s", flush=True)
        records, results = [], {}
        for wanted, job in (
                (args.app, partial(run_graph, g=g)),
                (args.serve, partial(run_serve, g=g)),
                (args.reorder, partial(run_reorder, g=g)),
                (args.moe, run_moe), (args.allreduce, run_allreduce)):
            if wanted:
                recs, res = job(args, dev, world)
                records += recs
                results.update(res)
        _report(records, args.out, results)
    finally:
        dist.destroy_process_group()


# -- the spawner --------------------------------------------------------------

def _die_with_parent() -> None:
    """In a child before exec: SIGKILL it when the launcher dies, so a
    launcher killed at its caller's timeout leaves no rank behind."""
    ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


def _without_nproc(argv: list[str]) -> list[str]:
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--nproc":
            skip = True
        elif not a.startswith("--nproc="):
            out.append(a)
    return out


def spawn(args, argv: list[str]) -> int:
    """Build the kernels once, start ``args.nproc`` ranks, wait for all;
    the first rank to fail stops the others and gives the exit code."""
    if rank_device(args.device).type == "cuda":
        from repro_torch.kernels import _build

        _build.build()
    tmp = tempfile.mkdtemp(prefix="partitioned-")
    child = _without_nproc(argv)
    if args.init_method is None:
        child += ["--init-method", f"file://{tmp}/store"]
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        WORLD_SIZE=str(args.nproc), LOCAL_WORLD_SIZE=str(args.nproc))
    procs = [subprocess.Popen(
        [sys.executable, "-m", MODULE, *child],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        preexec_fn=_die_with_parent) for r in range(args.nproc)]
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                return failed[0] if failed else 0
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if not (args.app or args.serve or args.reorder or args.moe
            or args.allreduce):
        raise SystemExit("nothing to run: give --app, --serve, --reorder, "
                         "--moe or --allreduce")
    runs = [parse_reorder(spec, i) for i, spec in enumerate(args.reorder)]
    if (args.app or args.serve or any(r["source"] == "pagerank"
                                      for r in runs)) and args.graph is None:
        raise SystemExit("--app, --serve and --reorder pagerank need --graph")
    for spec in args.app:
        parse_app(spec)
    if args.nproc is not None:
        return spawn(args, argv)
    rank_main(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

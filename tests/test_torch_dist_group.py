"""Port parity: one shard per rank of a ``torch.distributed`` group (the
partitioned pipeline, partitioned graph serving, the banked IRU engine's
rows, ``allreduce_int8`` and ``moe_hash_ep`` over a group mesh) against
the port's stacked shards and the reference on four forced JAX host
devices.

One launcher run (``python -m repro_torch.launch.partitioned --nproc 4``,
gloo on the CPU, a ``file://`` rendezvous in a temp dir) runs BFS with the
flag codec, SSSP exact and PageRank with ``int8_ef`` after 1 and 5
supersteps at P = 4 under a 3-rung ladder on kron-7 with the out-edges of
every seventh node dropped (reachable sinks, so PageRank and served PPR
leak mass), the fused serving engine on ``tile_csr`` of that graph with
three tenants at P = 4 in hash and sort mode (three tenants over four
shards cut tenants, so the tagged exchange crosses ranks), three banked
reorders of a seeded 4000-lane stream (min with ``round_cap`` at 4
partitions, add at 8, tagged and ragged at 4) and two of a skewed one whose
lanes all hash into one partition, so the banked layout bypasses its rows
(min with ``round_cap``, tagged and ragged),
``allreduce_int8`` and ``moe_hash_ep`` at a narrow width; the reference
runs the same in two subprocesses at the same time.  Labels, ``n_hops``,
``supersteps`` and ``boundary_traffic()`` are held equal, PageRank at rtol
1e-5, atol 0 (the int8 codes are the same on both sides; only f32 sum
order differs), MoE at ``test_torch_moe_ep.py``'s tolerances, served BFS
and SSSP bit for bit and PPR at rtol 1e-5, the banked streams bit for bit.
This file imports no JAX: the reference runs in its children, so the
card's test (``-m gpu``) collects it on the card machine too.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist
from filelock import FileLock

from repro_torch.configs.base import MoEConfig
from repro_torch.convert import graph_from_numpy, params_from_numpy
from repro_torch.core.pipeline import CapacityPolicy
from repro_torch.dist import graph_partition as gp
from repro_torch.dist.collectives import allreduce_int8
from repro_torch.graphs.csr import partition_csr, tile_csr
from repro_torch.graphs.generators import kron
from repro_torch.kernels.iru_reorder.banked import (banks,
                                                    hash_reorder_banked)
from repro_torch.kernels.iru_reorder.batched import _two_gen_plan, hash_set
from repro_torch.kernels.iru_reorder.ops import hash_reorder
from repro_torch.launch.mesh import make_graph_mesh, make_iru_mesh
from repro_torch.moe import moe_hash_ep
from repro_torch.moe.ep import shard_experts
from repro_torch.serve import (GraphQuery, GraphServeConfig,
                               GraphServingEngine)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
P = 4
LADDER = (3, 32, 4)  # n_buckets, min_capacity, growth: BFS hops rungs
RUNS = {"bfs_compress": ("bfs", True, None),
        "sssp": ("sssp", False, None),
        "pagerank_compress_iters1": ("pagerank", True, 1),
        "pagerank_compress_iters5": ("pagerank", True, 5)}
T, D, E, K, F = 128, 32, 8, 2, 48
MOE = dict(n_experts=E, top_k=K, d_ff=F, capacity_factor=2.0)
N_PARTITIONS = 8
# serving: three tenants of kron-7 over four shards, a 2-rung ladder
SLOTS, SERVE_LADDER, SERVE_MODES = 3, (2, 256, 16), ("hash", "sort")
QUERIES = [{"kind": "bfs", "source": 0}, {"kind": "sssp", "source": 3},
           {"kind": "ppr", "source": 9, "iters": 8},
           {"kind": "bfs", "source": 17},
           {"kind": "ppr", "source": 0, "iters": 5},
           {"kind": "sssp", "source": 9}]
# banked reorders of seeded streams: label -> hash_reorder's options and
# the stream's file; every lane of "skewed" hashes into partition 0 at
# P = 4, so its reorders bypass the bank rows
LANES, SETS, SLOTS_B = 4000, 64, 8
REORDERS = {"banked_min": dict(filter_op="min", round_cap=16, n_partitions=4),
            "banked_add": dict(filter_op="add", n_partitions=8),
            "banked_tagged": dict(filter_op="tagged", n_partitions=4,
                                  n_live=3100),
            "skewed_min": dict(filter_op="min", round_cap=16, n_partitions=4,
                               stream="skewed"),
            "skewed_tagged": dict(filter_op="tagged", n_partitions=4,
                                  n_live=3100, stream="skewed")}

_REFERENCE = """
import json
import numpy as np, jax, jax.numpy as jnp
from repro.configs.base import MoEConfig
from repro.core import CapacityPolicy
from repro.dist import graph_partition as gp
from repro.dist.collectives import allreduce_int8
from repro.graphs.csr import CSRGraph, partition_csr
from repro.launch.mesh import make_iru_mesh
from repro.moe import moe_hash_ep
assert len(jax.devices()) == 4, jax.devices()
z = np.load(DIR + "/graph.npz")
graph = CSRGraph(**{k: jnp.asarray(z[k])
                    for k in ("row_ptr", "col_idx", "weights")})
part = partition_csr(graph, 4)
policy = CapacityPolicy(*LADDER)
out, meta = {}, {}
for label, (app, compress, iters) in RUNS.items():
    kw = {"iters": iters} if iters else {}
    pipe = gp.PartitionedFrontierPipeline(
        part, getattr(gp, f"partitioned_{app}_app")(part, **kw),
        compress=compress, max_iters=iters, capacity_policy=policy)
    out[label] = np.asarray(pipe.run(0))
    meta[label] = [pipe.n_hops, pipe.supersteps, pipe.boundary_traffic()]
src = np.load(DIR + "/moe.npz")
layer = {k: jnp.asarray(src[k]) for k in ("router", "wi", "wg", "wo")}
ep = jax.jit(moe_hash_ep, static_argnums=(2, 3, 4),
             static_argnames=("n_partitions", "compress"))
mesh = make_iru_mesh(4)
assert mesh.shape["part"] == 4
for compress in (False, True):
    y, aux = ep(layer, jnp.asarray(src["x"]), MoEConfig(**MOE), "swiglu",
                mesh, n_partitions=N_PARTITIONS, compress=compress)
    label = "moe_int8" if compress else "moe_exact"
    out[label], out[label + "_aux"] = np.asarray(y), np.asarray(aux)
out["allreduce"] = np.asarray(allreduce_int8(
    jnp.asarray(np.load(DIR + "/allreduce.npy")), mesh, "part"))
np.savez(DIR + "/reference.npz", **out)
with open(DIR + "/reference.json", "w") as f:
    json.dump(meta, f)
"""


_REFERENCE_SERVE = """
import json
import numpy as np, jax, jax.numpy as jnp
from repro import serve as jserve
from repro.core import CapacityPolicy
from repro.graphs.csr import CSRGraph, partition_csr, tile_csr
from repro.kernels.iru_reorder.banked import hash_reorder_banked
from repro.launch.mesh import make_iru_mesh
assert len(jax.devices()) == 4, jax.devices()
out = {}
z = np.load(DIR + "/graph.npz")
graph = CSRGraph(**{k: jnp.asarray(z[k])
                    for k in ("row_ptr", "col_idx", "weights")})
view = partition_csr(tile_csr(graph, SLOTS), 4)
eng = jserve.GraphServingEngine(view, jserve.GraphServeConfig(
    query_slots=SLOTS, mode="hash",
    capacity_policy=CapacityPolicy(*SERVE_LADDER)))
qs = [jserve.GraphQuery(q["kind"], q["source"], iters=q.get("iters", 20))
      for q in QUERIES]
for q in qs:
    eng.submit(q)
eng.run_to_completion(2000)
assert all(q.status == "done" for q in qs), [q.error for q in qs]
for i, q in enumerate(qs):
    out[f"serve.q{i}"] = q.result
mesh = make_iru_mesh(4)
assert mesh.shape["part"] == 4
for label, kw in REORDERS.items():
    kw = dict(kw)
    z = np.load(DIR + "/" + kw.pop("stream", "stream") + ".npz")
    if "n_live" in kw:
        kw["n_live"] = jnp.int32(kw["n_live"])
    tags = jnp.asarray(z["tag_table"]) if kw["filter_op"] == "tagged" else None
    got = hash_reorder_banked(
        jnp.asarray(z["indices"]), jnp.asarray(z["secondary"]),
        num_sets=SETS, slots=SLOTS_B, tag_table=tags, mesh=mesh, **kw)
    for name, a in zip(("indices", "secondary", "positions", "active"), got):
        out[f"{label}.{name}"] = np.asarray(a)
np.savez(DIR + "/reference_serve.npz", **out)
with open(DIR + "/reference_serve.json", "w") as f:
    json.dump({"tick_no": eng.tick_no}, f)
"""


def _graph_arrays():
    """kron-7 (seed 4) with the out-edges of every seventh node dropped:
    sinks that other nodes reach, so served PPR leaks mass and the leak's
    sum over the shards has something to add."""
    g = kron(scale=7, edge_factor=8, seed=4, device="cpu")
    row_ptr, col_idx, weights = (t.numpy() for t in (g.row_ptr, g.col_idx,
                                                     g.weights))
    src = np.repeat(np.arange(g.n_nodes), np.diff(row_ptr))
    keep = src % 7 != 3
    deg = np.bincount(src[keep], minlength=g.n_nodes)
    return (np.concatenate([[0], np.cumsum(deg)]).astype(np.int32),
            col_idx[keep], weights[keep])


def _graph():
    return graph_from_numpy(*_graph_arrays(), "cpu")


def _reorder_spec(d, label: str) -> str:
    """The launcher's ``--reorder`` of run ``label``."""
    kw = REORDERS[label]
    spec = [str(d / f"{kw.get('stream', 'stream')}.npz"), f"sets={SETS}", f"slots={SLOTS_B}",
            f"parts={kw['n_partitions']}", f"op={kw['filter_op']}",
            f"label={label}"]
    if "round_cap" in kw:
        spec.append(f"round_cap={kw['round_cap']}")
    if "n_live" in kw:
        spec.append(f"live={kw['n_live']}")
    return ":".join(spec)


def _launcher(out_dir, *extra, nproc=P, backend="gloo", device="cpu"):
    """The launcher's command line at ``nproc`` ranks (a fresh store)."""
    return [sys.executable, "-m", "repro_torch.launch.partitioned",
            "--nproc", str(nproc), "--backend", backend, "--device", device,
            "--init-method", f"file://{out_dir}/store", "--timeout", "60",
            *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank launcher run and the reference's four-device run, made
    once a session: under xdist the first worker to ask makes them in the
    session's shared temp dir and the others wait on its lock."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # one dir a session, shared by its workers
    d = base / "torch_dist_group"
    with FileLock(str(d) + ".lock"):
        if not (d / "done").exists():
            d.mkdir(exist_ok=True)
            _make_runs(d)
            (d / "done").touch()
    layer = dict(np.load(d / "moe.npz"))
    return {"dir": d, "out": d / "out",
            "summary": json.loads((d / "out" / "summary.json").read_text()),
            "stdout": (d / "stdout.txt").read_text(), "layer": layer,
            "allreduce_x": np.load(d / "allreduce.npy"),
            "ref": dict(np.load(d / "reference.npz")),
            "ref_meta": json.loads((d / "reference.json").read_text()),
            "ref_serve": dict(np.load(d / "reference_serve.npz")),
            "ref_serve_meta": json.loads(
                (d / "reference_serve.json").read_text()),
            "streams": {k: dict(np.load(d / f"{k}.npz"))
                        for k in ("stream", "skewed")}}


def _make_runs(d) -> None:
    """Start both runs together, each with its own timeout, so a hung
    collective fails here."""
    (d / "store").unlink(missing_ok=True)  # a rendezvous file is single-use
    np.savez(d / "graph.npz", **dict(zip(("row_ptr", "col_idx", "weights"),
                                         _graph_arrays())))
    rng = np.random.default_rng(11)
    layer = {"router": rng.standard_normal((D, E)) * 0.3,
             "wi": rng.standard_normal((E, D, F)) * 0.2,
             "wg": rng.standard_normal((E, D, F)) * 0.2,
             "wo": rng.standard_normal((E, F, D)) * 0.2,
             "x": rng.standard_normal((T, D))}
    layer = {k: v.astype(np.float32) for k, v in layer.items()}
    np.savez(d / "moe.npz", **layer)
    (d / "moe").mkdir()
    for k, v in layer.items():
        np.save(d / "moe" / f"{k}.npy", v)
    (d / "moe" / "config.json").write_text(json.dumps(
        {"moe": MOE, "ffn_type": "swiglu", "n_partitions": N_PARTITIONS}))
    allreduce_x = rng.standard_normal((8, 5, 40)).astype(np.float32)
    np.save(d / "allreduce.npy", allreduce_x)

    stream = {"indices": rng.integers(0, 3000, LANES).astype(np.int32),
              "secondary": rng.random(LANES).astype(np.float32),
              "tag_table": rng.random(3001) < 0.5}
    np.savez(d / "stream.npz", **stream)
    pool = rng.integers(0, 3000, 8 * LANES).astype(np.int32)
    in0 = pool[hash_set(torch.from_numpy(pool // 32), SETS).numpy() % 4 == 0]
    assert in0.shape[0] >= LANES
    np.savez(d / "skewed.npz", indices=in0[:LANES],
             secondary=rng.random(LANES).astype(np.float32),
             tag_table=stream["tag_table"])
    for mode in SERVE_MODES:
        (d / f"serve_{mode}.json").write_text(json.dumps({
            "queries": QUERIES, "slots": SLOTS, "mode": mode,
            "capacity_policy": SERVE_LADDER}))

    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = (f"DIR = {str(d)!r}\nLADDER = {LADDER!r}\nRUNS = {RUNS!r}\n"
            f"MOE = {MOE!r}\nN_PARTITIONS = {N_PARTITIONS}\n"
            + textwrap.dedent(_REFERENCE))
    code_serve = (f"DIR = {str(d)!r}\nSLOTS = {SLOTS}\nSERVE_LADDER = "
                  f"{SERVE_LADDER!r}\nQUERIES = {QUERIES!r}\nREORDERS = "
                  f"{REORDERS!r}\nSETS = {SETS}\nSLOTS_B = {SLOTS_B}\n"
                  + textwrap.dedent(_REFERENCE_SERVE))
    refs = [subprocess.Popen([sys.executable, "-c", c], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for c in (code, code_serve)]
    specs = {"bfs_compress": "bfs:compress", "sssp": "sssp",
             "pagerank_compress_iters1": "pagerank:iters=1:compress",
             "pagerank_compress_iters5": "pagerank:iters=5:compress"}
    cmd = _launcher(d, "--graph", str(d / "graph.npz"), "--ladder",
                    ",".join(map(str, LADDER)), "--out", str(d / "out"),
                    "--moe", str(d / "moe"), "--allreduce",
                    str(d / "allreduce.npy"),
                    *[a for s in specs.values() for a in ("--app", s)],
                    *[a for m in SERVE_MODES
                      for a in ("--serve", str(d / f"serve_{m}.json"))],
                    *[a for label in REORDERS
                      for a in ("--reorder", _reorder_spec(d, label))])
    try:
        # one OpenMP thread a rank: four ranks at the host's thread count
        # beside xdist's workers oversubscribe the cores (the ragged
        # reorders' round loops then took seconds a call)
        group = subprocess.run(
            cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC,
                                    OMP_NUM_THREADS="1"),
            capture_output=True, text=True, timeout=180)
        ref_errs = [ref.communicate(timeout=300)[1] for ref in refs]
    finally:
        for ref in refs:
            ref.kill()
            ref.wait()
    assert group.returncode == 0, group.stderr[-4000:]
    for ref, err in zip(refs, ref_errs):
        assert ref.returncode == 0, err[-4000:]
    (d / "stdout.txt").write_text(group.stdout)


@pytest.fixture(scope="module")
def stacked():
    """The port's stacked shards on the same graph, ladder and runs."""
    part = partition_csr(_graph(), P)
    out = {}
    for label, (app, compress, iters) in RUNS.items():
        kw = {"iters": iters} if iters else {}
        pipe = gp.PartitionedFrontierPipeline(
            part, getattr(gp, f"partitioned_{app}_app")(part, **kw),
            compress=compress, max_iters=iters,
            capacity_policy=CapacityPolicy(*LADDER), device="cpu")
        out[label] = (pipe.run(0).numpy(), pipe)
    return part, out


def _records(runs, label):
    """Every rank's record of run ``label``."""
    return [next(r for r in recs if r["label"] == label)
            for recs in runs["summary"]]


def _result(runs, label):
    return np.load(runs["out"] / f"{label}.npy")


# ---------------------------------------------------------------------------
# the partitioned pipeline over four ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", list(RUNS))
def test_group_run_matches_stacked_and_reference(runs, stacked, label):
    got, ref = _result(runs, label), runs["ref"][label]
    want, pipe = stacked[1][label]
    if label.startswith("pagerank"):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    else:
        assert got.dtype == want.dtype == ref.dtype
        assert np.array_equal(got, ref) and np.array_equal(got, want)
    hops, steps, traffic = runs["ref_meta"][label]
    for rec in _records(runs, label):  # every rank agrees
        assert (rec["n_hops"], rec["supersteps"]) == (hops, steps) == (
            pipe.n_hops, pipe.supersteps)
        assert rec["traffic"] == traffic == pipe.boundary_traffic()
    if label == "bfs_compress":
        assert hops > 1 and traffic["codec"] == "flag"
    assert label in runs["stdout"]


@pytest.mark.parametrize("label", list(RUNS))
def test_group_all_to_all_carries_the_codec_wire_bytes(runs, label):
    """What the ranks hand ``all_to_all_single`` for other ranks, summed,
    is the codec's wire bytes (flag: int8; int8_ef: ``q`` and ``s``)."""
    recs = _records(runs, label)
    sent = sum(r["sent_bytes"] for r in recs)
    assert sent == recs[0]["traffic"]["wire_bytes_total"] > 0


def test_each_rank_holds_its_own_shard_state_and_experts(runs, stacked):
    part = stacked[0]
    recs = _records(runs, "sssp")
    assert sum(r["partition_bytes"] for r in recs) == part.nbytes()
    for rec in recs:
        held = rec["held"]
        for k in part._TENSORS:
            assert held[f"part.{k}"] == [1, *getattr(part, k).shape[1:]], k
        assert held["state.dist"] == [1, part.local_nodes]
        assert held["degrees"] == [1, part.local_nodes]
        assert held["ef"] == [1, P, part.lane_cap]
    for rec in _records(runs, "pagerank_compress_iters5"):
        assert rec["held"]["state.rank"] == [1, part.local_nodes]
        assert rec["held"]["state.it"] == [1]
    for rec in _records(runs, "moe_exact"):
        held = rec["held"]
        assert held["wi"] == held["wg"] == [E // P, D, F]
        assert held["wo"] == [E // P, F, D]
        assert held["router"] == [D, E] and held["experts"] == [E // P]


# ---------------------------------------------------------------------------
# partitioned serving and the banked engine's rows over four ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stacked_serving():
    """The port's stacked engine at P = 4 (every shard in this process) on
    the launcher's graph, queries and ladder, in each mode."""
    pview = partition_csr(tile_csr(_graph(), SLOTS), P)
    out = {}
    for mode in SERVE_MODES:
        eng = GraphServingEngine(pview, GraphServeConfig(
            query_slots=SLOTS, mode=mode,
            capacity_policy=CapacityPolicy(*SERVE_LADDER)), device="cpu")
        qs = [GraphQuery(q["kind"], q["source"], iters=q.get("iters", 20))
              for q in QUERIES]
        for q in qs:
            eng.submit(q)
        eng.run_to_completion(2000)
        out[mode] = (eng, qs)
    return pview, out


def _same_query(got, want, kind, what):
    assert got.dtype == want.dtype, what
    if kind == "ppr":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                   err_msg=what)
    else:
        assert np.array_equal(got, want), what


@pytest.mark.parametrize("mode", SERVE_MODES)
def test_group_serving_matches_stacked_and_reference(runs, stacked_serving,
                                                     mode):
    """Four ranks, one shard each: every query equals the stacked engine's
    (BFS and SSSP bit for bit, PPR at rtol 1e-5) and the reference engine's
    on four devices, in as many ticks; the tagged exchange crosses ranks."""
    pview, engines = stacked_serving
    eng, qs = engines[mode]
    label = f"serve_{mode}"
    for i, q in enumerate(qs):
        assert q.status == "done", q.error
        got = _result(runs, f"{label}.q{i}")
        _same_query(got, q.result, q.kind, f"{label} q{i} against stacked")
        _same_query(got, runs["ref_serve"][f"serve.q{i}"], q.kind,
                    f"{label} q{i} against the reference")
    assert pview.part.lane_cap > 0
    recs = _records(runs, label)
    for rec in recs:  # every rank decided the same
        assert (rec["ticks"], rec["overflow_events"], rec["quarantines"],
                rec["admission_blocked"], rec["lane_cap"]) == (
            eng.tick_no, eng.overflow_events, eng.quarantines,
            eng.admission_blocked, pview.part.lane_cap)
    assert eng.tick_no == runs["ref_serve_meta"]["tick_no"]
    assert sum(r["sent_bytes"] for r in recs) > 0  # the exchange ran
    assert sum(r["partition_bytes"] for r in recs) == pview.part.nbytes()
    assert label in runs["stdout"]


def _stream_args(runs, label):
    kw = dict(REORDERS[label])
    z = runs["streams"][kw.pop("stream", "stream")]
    tags = (torch.from_numpy(z["tag_table"]) if kw["filter_op"] == "tagged"
            else None)
    return (torch.from_numpy(z["indices"]), torch.from_numpy(z["secondary"]),
            tags, kw)


@pytest.mark.parametrize("label", list(REORDERS))
def test_group_banked_rows_match_single_process_and_reference(runs, label):
    """Each rank reorders its block of bank rows (two a rank at 8
    partitions), or, on the skewed stream, the whole stream flat: the
    stream equals the single-process banked engine's and the reference's
    ``hash_reorder_banked(mesh=)`` on four devices, bit for bit, field by
    field."""
    idx, sec, tags, kw = _stream_args(runs, label)
    want = hash_reorder_banked(idx, sec, num_sets=SETS, slots=SLOTS_B,
                               tag_table=tags, **kw)
    for name, w in zip(("indices", "secondary", "positions", "active"),
                       want):
        got = _result(runs, f"{label}.{name}")
        assert got.dtype == w.numpy().dtype, name
        assert np.array_equal(got, w.numpy()), (label, name)
        assert np.array_equal(got, runs["ref_serve"][f"{label}.{name}"]), (
            label, name)
    per = kw["n_partitions"] // P
    for r, rec in enumerate(_records(runs, label)):
        assert rec["partitions"] == list(range(r * per, (r + 1) * per))


def test_group_banked_streams_take_the_row_stage(runs):
    """The uniform stream's runs take the rows (every partition fits its
    bank) and the skewed stream's bypass them (partition 0 holds every live
    lane, past the capacity); no ragged run's two-generation closed form
    holds, so both paths are reached."""
    for label in REORDERS:
        idx, sec, tags, kw = _stream_args(runs, label)
        sets, part, live, m_live, cnt, cap = banks(
            idx, num_sets=SETS, n_partitions=kw["n_partitions"], epb=32,
            n_live=kw.get("n_live"))
        if label.startswith("skewed"):
            assert int(cnt[0]) == m_live > cap, label
        else:
            assert int(cnt.max()) <= cap, label
        if live is not None:
            ok, _ = _two_gen_plan(
                idx, sec, live, sets, n_partitions=kw["n_partitions"],
                num_sets=SETS, slots=SLOTS_B, filter_op=kw["filter_op"],
                round_cap=None, tag_table=tags)
            assert not bool(ok), label


# ---------------------------------------------------------------------------
# allreduce_int8 and moe_hash_ep over four ranks
# ---------------------------------------------------------------------------

def _quanta_ok(got: np.ndarray, want: np.ndarray, n_shards: int) -> None:
    """|got - want| within ``n_shards`` quanta of each 128-block of
    ``want`` (``test_torch_moe_ep.py``'s bound)."""
    g, w = got.reshape(-1), want.reshape(-1)
    pad = (-w.shape[0]) % 128
    wb = np.pad(w, (0, pad)).reshape(-1, 128)
    db = np.pad(np.abs(g - w), (0, pad)).reshape(-1, 128)
    quantum = np.abs(wb).max(1, keepdims=True) / 127.0
    assert (db <= n_shards * quantum).all(), (db - n_shards * quantum).max()


def test_group_allreduce_int8(runs):
    got = _result(runs, "allreduce")
    want = allreduce_int8(torch.from_numpy(runs["allreduce_x"]), P).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, runs["ref"]["allreduce"], rtol=1e-6,
                               atol=1e-6)


def test_group_moe_hash_ep(runs):
    layer = runs["layer"]
    params = params_from_numpy({k: layer[k] for k in ("router", "wi", "wg",
                                                      "wo")}, "cpu")
    x, moe, ref = torch.from_numpy(layer["x"]), MoEConfig(**MOE), runs["ref"]
    ye, auxe = moe_hash_ep(params, x, moe, "swiglu", n_shards=P,
                           n_partitions=N_PARTITIONS, compress=False)
    yc, _ = moe_hash_ep(params, x, moe, "swiglu", n_shards=P,
                        n_partitions=N_PARTITIONS)
    got = _result(runs, "moe_exact")
    np.testing.assert_allclose(got, ref["moe_exact"], rtol=1e-5,
                               atol=1e-6 * np.abs(ref["moe_exact"]).max())
    np.testing.assert_allclose(got, ye.numpy(), rtol=1e-5, atol=1e-6)
    for label in ("moe_exact", "moe_int8"):
        aux = _result(runs, f"{label}_aux")
        np.testing.assert_allclose(aux, ref[f"{label}_aux"], rtol=1e-6)
        assert float(aux) == float(auxe)
    got = _result(runs, "moe_int8")
    _quanta_ok(got, ref["moe_int8"], P)
    _quanta_ok(got, yc.numpy(), P)
    assert np.abs(ref["moe_int8"] - ref["moe_exact"]).max() > 0  # lossy


# ---------------------------------------------------------------------------
# a group of one in this process, and the refusals
# ---------------------------------------------------------------------------

@pytest.fixture
def group_of_one(tmp_path):
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_group_of_one_and_its_refusals(group_of_one):
    g = kron(scale=6, device="cpu")
    mesh = make_graph_mesh(1, "cpu", group="world")
    assert mesh.shape == {"gpart": 1} and mesh.devices == (
        torch.device("cpu"),)
    for compress in (False, True):
        assert torch.equal(
            gp.bfs_partitioned(g, 0, mesh=mesh, mode="hash",
                               compress=compress),
            gp.bfs_partitioned(g, 0, n_parts=1, mode="hash",
                               compress=compress, device="cpu"))
    # a group of one cannot hold two shards: the reference's words
    part = partition_csr(g, 2)
    with pytest.raises(ValueError) as e:
        gp.PartitionedFrontierPipeline(part, gp.partitioned_bfs_app(part),
                                       mesh=mesh)
    assert str(e.value) == "mesh axis 'gpart' has size 1, partition has 2 " \
                           "shards"
    with pytest.raises(ValueError, match="need 2 ranks for 2 graph shards"):
        make_graph_mesh(2, "cpu", group="world")
    with pytest.raises(ValueError, match="without a process group"):
        gp.PartitionedFrontierPipeline(
            part, gp.partitioned_bfs_app(part),
            mesh=dataclasses.replace(mesh, group=None,
                                     axis_sizes=(2,),
                                     devices=(mesh.devices[0],) * 2))
    # the whole layer on a rank: refused, its own experts taken
    rng = np.random.default_rng(0)
    moe = MoEConfig(n_experts=4, top_k=2, d_ff=8)
    layer = {"router": rng.standard_normal((8, 4)),
             "wi": rng.standard_normal((4, 8, 8)),
             "wg": rng.standard_normal((4, 8, 8)),
             "wo": rng.standard_normal((4, 8, 8))}
    layer = {k: v.astype(np.float32) for k, v in layer.items()}
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    imesh = make_iru_mesh(2, "cpu", group="world")
    with pytest.raises(ValueError, match="shard_experts"):
        moe_hash_ep(params_from_numpy(layer, "cpu"), x, moe, "swiglu",
                    mesh=imesh, n_partitions=2)
    mine = params_from_numpy(shard_experts(layer, moe, 1, 0, 2), "cpu")
    y, _ = moe_hash_ep(mine, x, moe, "swiglu", mesh=imesh, n_partitions=2)
    want, _ = moe_hash_ep(params_from_numpy(layer, "cpu"), x, moe, "swiglu",
                          n_shards=1, n_partitions=2)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)
    # the process group goes: a group mesh refuses, never runs stacked
    dist.destroy_process_group()
    part1 = partition_csr(g, 1)
    with pytest.raises(RuntimeError, match="not initialized"):
        gp.PartitionedFrontierPipeline(part1, gp.partitioned_bfs_app(part1),
                                       mesh=mesh)
    with pytest.raises(RuntimeError, match="not initialized"):
        make_graph_mesh(1, "cpu", group="world")
    with pytest.raises(RuntimeError, match="not initialized"):
        allreduce_int8(torch.ones(2, 3), mesh=imesh)


def test_group_of_one_serves_and_reorders_and_refuses(group_of_one):
    """A group of one serves as the stacked engine does and reorders as the
    single-process banked engine does (two partitions on the one rank);
    what a mesh cannot honour raises, and nothing falls back."""
    g = kron(scale=6, device="cpu")
    cfg = GraphServeConfig(query_slots=2,
                           capacity_policy=CapacityPolicy(*SERVE_LADDER))
    mesh = make_graph_mesh(1, "cpu", group="world")
    one = partition_csr(tile_csr(g, 2), 1)

    def serve(**kw):
        eng = GraphServingEngine(one, cfg, **kw)
        qs = [GraphQuery("bfs", 0), GraphQuery("ppr", 3, iters=4),
              GraphQuery("sssp", 5)]
        for q in qs:
            eng.submit(q)
        eng.run_to_completion(500)
        return [q.result for q in qs], eng.tick_no

    got, want = serve(mesh=mesh), serve(device="cpu")
    assert got[1] == want[1]
    for a, b in zip(got[0], want[0]):
        assert np.array_equal(a, b)
    nogroup = dataclasses.replace(mesh, group=None)
    with pytest.raises(ValueError, match="without a process group"):
        GraphServingEngine(one, cfg, mesh=nogroup)
    with pytest.raises(ValueError, match="a CSRGraph has no shards"):
        GraphServingEngine(g, cfg, mesh=mesh)
    with pytest.raises(ValueError) as e:  # a group of the wrong size
        GraphServingEngine(partition_csr(tile_csr(g, 2), 2), cfg, mesh=mesh)
    assert str(e.value) == "mesh axis 'gpart' has size 1, partition has 2 " \
                           "shards"
    with pytest.raises(ValueError, match="requires fused=True"):
        GraphServingEngine(one, dataclasses.replace(cfg, fused=False),
                           mesh=mesh)
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 500, 600).astype(np.int32))
    sec = torch.from_numpy(rng.random(600).astype(np.float32))
    imesh = make_iru_mesh(2, "cpu", group="world")
    kw = dict(num_sets=16, slots=4, filter_op="add", n_partitions=2)
    for a, b in zip(hash_reorder(idx, sec, mesh=imesh, **kw),
                    hash_reorder(idx, sec, **kw)):
        assert torch.equal(a, b)
    # one partition: the reference's words, from either entry point
    for fn in (hash_reorder, hash_reorder_banked):
        with pytest.raises(ValueError) as e:
            fn(idx, sec, n_partitions=1, mesh=imesh)
        assert str(e.value) == (
            "mesh sharding requires n_partitions > 1 (the mesh shards bank "
            "rows; a single partition has nothing to shard)")
    with pytest.raises(ValueError, match="without a process group"):
        hash_reorder(idx, sec, mesh=dataclasses.replace(imesh, group=None),
                     **kw)
    with pytest.raises(ValueError, match="windows take no mesh"):
        hash_reorder(idx, sec, window_elems=128, mesh=imesh, **kw)


@pytest.mark.gpu
def test_nccl_ranks_sharing_a_card_refuse(tmp_path):
    """Two NCCL ranks on one card raise and name the reason (NCCL itself
    would fail its first collective with "invalid usage")."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs on CUDA devices only")
    r = subprocess.run(
        _launcher(tmp_path, "--graph", "kron:7:8", "--app", "bfs",
                  nproc=2, backend="nccl", device="cuda:0"),
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=120)
    assert r.returncode != 0
    assert "NCCL needs one card per rank" in r.stderr, r.stderr[-4000:]


@pytest.mark.gpu
def test_banked_rows_on_the_card_equal_the_banked_layout(tmp_path):
    """On the card a group of one reorders its four partitions through
    B3's whole-stream body, one launch each on the partition's
    sub-stream, and equals B3's banked layout bit for bit: merged, ragged,
    tagged and unmerged.  A stream whose lanes all hash into one partition
    bypasses the rows (one launch of the whole-stream body on the whole
    stream) and equals the banked layout too, whole and ragged.  Under a
    round cap each partition's launch decides its own fallback, as the
    banked layout does by partition."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B3 has no CPU body")
    from repro_torch.kernels import launch_counts, reset_launch_counts

    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/store", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_iru_mesh(4, "cuda:0", group="world")
        rng = np.random.default_rng(7)
        n, span = 1 << 16, 1 << 18
        idx = torch.from_numpy(rng.integers(0, span, n).astype(np.int32))
        sec = torch.from_numpy(rng.random(n).astype(np.float32))
        tags = torch.from_numpy(rng.random(span + 1) < 0.5).cuda()
        # every lane's block hashes into partition 0 of 4
        pool = torch.from_numpy(rng.integers(0, span, 8 * n).astype(np.int32))
        skewed = pool[hash_set(pool // 32, 1024) % 4 == 0][:n]
        assert skewed.shape[0] == n
        idx, sec, skewed = idx.cuda(), sec.cuda(), skewed.cuda()
        for x, kw, launches in (
                (idx, dict(filter_op="add"), 4),
                (idx, dict(filter_op="min", n_live=n - 1000), 4),
                (idx, dict(filter_op="tagged", tag_table=tags, n_live=n // 2),
                 4),
                (idx, dict(filter_op=None), 4),
                (skewed, dict(filter_op="add"), 1),
                (skewed, dict(filter_op="min", n_live=n - 1000), 1),
                # capped at one round and at two, tagged and ragged, and
                # the bypass under a cap
                (idx, dict(filter_op="add", round_cap=1), 4),
                (idx, dict(filter_op="min", round_cap=2), 4),
                (idx, dict(filter_op="tagged", tag_table=tags, round_cap=2,
                           n_live=n // 2), 4),
                (skewed, dict(filter_op="add", round_cap=3,
                              n_live=n - 1000), 1)):
            reset_launch_counts()
            got = hash_reorder(x, sec, n_partitions=4, mesh=mesh, **kw)
            key = ("iru_reorder_round_cap" if "round_cap" in kw
                   else "iru_reorder_tagged" if kw["filter_op"] == "tagged"
                   else "iru_reorder")
            assert dict(launch_counts) == {key: launches}, kw
            want = hash_reorder(x, sec, n_partitions=4, **kw)
            for name, a, b in zip(got._fields, got, want):
                assert torch.equal(a, b), (kw["filter_op"], launches, name)
    finally:
        dist.destroy_process_group()

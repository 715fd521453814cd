"""Port parity: one shard per rank of a ``torch.distributed`` group (the
partitioned pipeline, ``allreduce_int8`` and ``moe_hash_ep`` over a group
mesh) against the port's stacked shards and the reference on four forced
JAX host devices.

One launcher run (``python -m repro_torch.launch.partitioned --nproc 4``,
gloo on the CPU, a ``file://`` rendezvous in a temp dir) runs BFS with the
flag codec, SSSP exact and PageRank with ``int8_ef`` after 1 and 5
supersteps on kron-7 at P = 4 under a 3-rung ladder, ``allreduce_int8``
and ``moe_hash_ep`` at a narrow width; the reference runs the same in one
subprocess at the same time.  Labels, ``n_hops``, ``supersteps`` and
``boundary_traffic()`` are held equal, PageRank at rtol 1e-5, atol 0 (the
int8 codes are the same on both sides; only f32 sum order differs), MoE at
``test_torch_moe_ep.py``'s tolerances.  This file imports no JAX: the
reference runs in its child, so the card's test (``-m gpu``) collects it
on the card machine too.
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
from repro_torch.convert import params_from_numpy
from repro_torch.core.pipeline import CapacityPolicy
from repro_torch.dist import graph_partition as gp
from repro_torch.dist.collectives import allreduce_int8
from repro_torch.graphs.csr import partition_csr
from repro_torch.graphs.generators import kron
from repro_torch.launch.mesh import make_graph_mesh, make_iru_mesh
from repro_torch.moe import moe_hash_ep
from repro_torch.moe.ep import shard_experts

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

_REFERENCE = """
import json
import numpy as np, jax, jax.numpy as jnp
from repro.configs.base import MoEConfig
from repro.core import CapacityPolicy
from repro.dist import graph_partition as gp
from repro.dist.collectives import allreduce_int8
from repro.graphs.csr import partition_csr
from repro.graphs.generators import kron
from repro.launch.mesh import make_iru_mesh
from repro.moe import moe_hash_ep
assert len(jax.devices()) == 4, jax.devices()
part = partition_csr(kron(scale=7, edge_factor=8, seed=4), 4)
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
            "ref_meta": json.loads((d / "reference.json").read_text())}


def _make_runs(d) -> None:
    """Start both runs together, each with its own timeout, so a hung
    collective fails here."""
    (d / "store").unlink(missing_ok=True)  # a rendezvous file is single-use
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

    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = (f"DIR = {str(d)!r}\nLADDER = {LADDER!r}\nRUNS = {RUNS!r}\n"
            f"MOE = {MOE!r}\nN_PARTITIONS = {N_PARTITIONS}\n"
            + textwrap.dedent(_REFERENCE))
    ref = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    specs = {"bfs_compress": "bfs:compress", "sssp": "sssp",
             "pagerank_compress_iters1": "pagerank:iters=1:compress",
             "pagerank_compress_iters5": "pagerank:iters=5:compress"}
    cmd = _launcher(d, "--graph", "kron:7:8:4", "--ladder",
                    ",".join(map(str, LADDER)), "--out", str(d / "out"),
                    "--moe", str(d / "moe"), "--allreduce",
                    str(d / "allreduce.npy"),
                    *[a for s in specs.values() for a in ("--app", s)])
    try:
        group = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ,
                                                       PYTHONPATH=SRC),
                               capture_output=True, text=True, timeout=120)
        _, ref_err = ref.communicate(timeout=300)
    finally:
        ref.kill()
        ref.wait()
    assert group.returncode == 0, group.stderr[-4000:]
    assert ref.returncode == 0, ref_err[-4000:]
    (d / "stdout.txt").write_text(group.stdout)


@pytest.fixture(scope="module")
def stacked():
    """The port's stacked shards on the same graph, ladder and runs."""
    part = partition_csr(kron(scale=7, edge_factor=8, seed=4, device="cpu"),
                         P)
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

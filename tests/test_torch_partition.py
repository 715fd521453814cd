"""Port parity: the edge-partitioned frontier pipeline (``dist``), its
partitioner (``graphs.csr.partition_csr``, ``suggest_partitions``) and the
boundary codecs, against ``repro.dist.graph_partition`` and
``repro.graphs.csr``.

Graphs come from the reference's seeded generators (kron scale 7, delaunay
16 x 16) and cross as numpy.  The partitions, ``suggest_partitions`` and the
codecs equal the reference's bit for bit.  Partitioned BFS and SSSP equal
the reference's single-device pipelines bit for bit at P = 1, 2 and 4;
partitioned PageRank is held to rtol = atol = 1e-4 with the exact codec and
2e-3 with ``int8_ef`` (the reference's own tolerances,
``tests/test_graph_partition.py``).  At P = 1 the port's wrappers equal the
reference's partitioned wrappers, ``supersteps`` and ``n_hops`` included.
The one subprocess test forces four JAX host devices to run the
reference at P = 4, as ``tests/test_graph_partition.py`` does.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro.apps import bfs_pipeline, pagerank_pipeline, sssp_pipeline
from repro.core.pipeline import CapacityPolicy as JPolicy
from repro.dist import graph_partition as jdist
from repro.graphs import csr as jcsr
from repro.graphs.generators import delaunay as jdelaunay
from repro.graphs.generators import kron as jkron
from repro_torch.convert import partition_from_numpy
from repro_torch.core.pipeline import CapacityPolicy as TPolicy
from repro_torch.dist import graph_partition as tdist
from repro_torch.graphs import csr as tcsr
from torch_parity import jax_graph_to_torch, n, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = ("n_nodes", "n_edges", "n_parts", "block", "ghost_cap",
            "lane_cap", "edge_cap")
MODES = ("baseline", "sort", "hash")
LADDER = dict(n_buckets=3, min_capacity=32, growth=4)  # hops at kron-7
# two rungs at P = 1: every rung is one JAX compile of the reference's
# superstep, and the hash engine's compile dominates the file's time
ONE_SHARD_LADDER = dict(n_buckets=2, min_capacity=256, growth=4)


@pytest.fixture(scope="module")
def graphs():
    """name -> (reference graph, port graph on the CPU)."""
    out = {}
    for name, g in (("kron", jkron(scale=7, edge_factor=8, seed=4)),
                    ("delaunay", jdelaunay(scale=16))):
        out[name] = (g, jax_graph_to_torch(g))
    return out


@pytest.fixture(scope="module")
def single_device(graphs):
    """The reference's single-device results the partitioned runs equal:
    BFS and SSSP from node 0, PageRank of 5 iterations."""
    return {name: (n(bfs_pipeline(g, 0)), n(sssp_pipeline(g, 0)),
                   n(pagerank_pipeline(g, iters=5)))
            for name, (g, _) in graphs.items()}


def _assert_same_partition(want, got):
    for f in GEOMETRY:
        assert getattr(got, f) == getattr(want, f), f
    assert got.local_nodes == want.local_nodes
    for f in tcsr.GraphPartition._TENSORS:
        a, b = np.asarray(getattr(want, f)), n(getattr(got, f))
        assert b.dtype == a.dtype and b.shape == a.shape, f
        assert np.array_equal(b, a), f


# ---------------------------------------------------------------------------
# the partitioner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n_parts,edge_align", [
    ("kron", 1, 8), ("kron", 2, 8), ("kron", 4, 8), ("kron", 4, 64),
    ("delaunay", 1, 8), ("delaunay", 2, 8), ("delaunay", 4, 8),
    ("delaunay", 3, 128)])
def test_partition_csr_matches_reference(graphs, name, n_parts, edge_align):
    jg, tg = graphs[name]
    want = jcsr.partition_csr(jg, n_parts, edge_align=edge_align)
    got = tcsr.partition_csr(tg, n_parts, edge_align=edge_align)
    _assert_same_partition(want, got)
    _assert_same_partition(want, partition_from_numpy(want, "cpu"))
    for p in range(n_parts):  # the shard view is an exact row-range crop
        sub = got.shard_graph(p)
        assert sub.n_nodes == got.local_nodes
        assert torch.equal(sub.col_idx, got.col_idx[p])
    assert got.nbytes() == sum(np.asarray(getattr(want, f)).nbytes
                               for f in tcsr.GraphPartition._TENSORS)


@pytest.mark.parametrize("copies,n_parts", [(3, 2), (2, 4)])
def test_partition_csr_of_a_view_matches_reference(graphs, copies, n_parts):
    """``partition_csr(tile_csr(g, Q), P)``: the composite's partition plus
    its tenant geometry; ``partition_from_numpy`` carries a reference
    view across."""
    jg, tg = graphs["kron"]
    want = jcsr.partition_csr(jcsr.tile_csr(jg, copies), n_parts)
    got = tcsr.partition_csr(tcsr.tile_csr(tg, copies), n_parts)
    for pv in (got, partition_from_numpy(want, "cpu")):
        assert isinstance(pv, tcsr.PartitionedGraphView)
        _assert_same_partition(want.part, pv.part)
        assert (pv.n_nodes, pv.n_edges, pv.n_parts, pv.n_tenants,
                pv.base_nodes) == (want.n_nodes, want.n_edges, want.n_parts,
                                   want.n_tenants, want.base_nodes)
        assert torch.equal(pv.view.col_idx, t(want.view.col_idx))


def test_partition_validation_matches_reference(graphs):
    jg, tg = graphs["delaunay"]
    for bad in (0, jg.n_nodes + 1):
        with pytest.raises(ValueError) as want:
            jcsr.partition_csr(jg, bad)
        with pytest.raises(ValueError) as got:
            tcsr.partition_csr(tg, bad)
        assert str(got.value).split(" -")[0] == str(want.value).split(
            " —")[0]


@pytest.mark.parametrize("budget", [1 << 12, 1 << 14, 1 << 16, 1 << 30,
                                    50 * 2 ** 20])
def test_suggest_partitions_matches_reference(graphs, budget):
    for jg, tg in graphs.values():
        for arrays in (1, 2):
            assert tcsr.suggest_partitions(
                tg, vmem_bytes=budget, state_arrays=arrays) == \
                jcsr.suggest_partitions(jg, vmem_bytes=budget,
                                        state_arrays=arrays)
    # the default budget is the H100's 50 MiB L2, where the reference's
    # was the TPU's 16 MiB of VMEM (kron-20's size: only the node and edge
    # counts are read)
    g = types.SimpleNamespace(n_nodes=1 << 20, n_edges=31_000_000)
    assert tcsr.suggest_partitions(g) == jcsr.suggest_partitions(
        g, vmem_bytes=50 * 2 ** 20) < jcsr.suggest_partitions(g)


# ---------------------------------------------------------------------------
# the codecs
# ---------------------------------------------------------------------------

def _payloads(seed: int) -> np.ndarray:
    """[6, 200] f32 rows: normal values, exact half quanta (round half to
    even), a zero row and a one-hot row."""
    rng = np.random.default_rng(seed)
    y = (rng.normal(size=(6, 200)) * 10).astype(np.float32)
    y[1, :128] = (np.arange(128) - 63.5).astype(np.float32)  # .5 quanta
    y[1, 0] = 127.0  # block max: scale 1.0, so y / scale is y exactly
    y[2] = 0.0
    y[3] = 0.0
    y[3, 130] = 3.0
    return y


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_rows_i8_matches_reference(seed):
    y = _payloads(seed)
    jq, js = jdist.quantize_rows_i8(y)
    tq, ts = tdist.quantize_rows_i8(t(y))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(n(tq), np.asarray(jq))
    assert np.array_equal(n(ts), np.asarray(js))
    assert np.array_equal(n(tdist.dequantize_rows_i8(tq, ts)),
                          np.asarray(jdist.dequantize_rows_i8(jq, js)))
    assert n(tq)[1, 64] == 0 and n(tq)[1, 65] == 2  # -0.5 -> 0, 1.5 -> 2


@pytest.mark.parametrize("codec,dtype", [("exact", np.float32),
                                         ("flag", np.int32),
                                         ("int8_ef", np.float32)])
def test_encode_decode_match_reference(codec, dtype):
    """Two rounds through each codec (``int8_ef`` carries its
    error-feedback buffer into the second): wire arrays, the new buffer
    and the decoded values bit for bit."""
    rng = np.random.default_rng(3)
    if dtype == np.int32:
        ident = int(np.iinfo(np.int32).max)
        send = np.where(rng.random((4, 150)) < 0.3, 7, ident).astype(dtype)
    else:
        ident = 0.0
        send = (rng.random((4, 150)) * 1e-3).astype(dtype)
    jef = np.zeros((4, 150), np.float32)
    tef = t(jef)
    for _ in range(2):
        jwire, jef = jdist._encode(codec, send, jef, ident)
        twire, tef = tdist._encode(codec, t(send), tef, ident)
        assert sorted(twire) == sorted(jwire)
        for k in jwire:
            assert np.array_equal(n(twire[k]), np.asarray(jwire[k])), k
        assert np.array_equal(n(tef), np.asarray(jef))
        jrecv = jdist._decode(codec, jwire, ident, dtype, 7)
        trecv = tdist._decode(codec, twire, ident, {
            np.float32: torch.float32, np.int32: torch.int32}[dtype], 7)
        assert np.array_equal(n(trecv), np.asarray(jrecv))
        send = send[::-1].copy()


def test_wire_bytes_match_reference():
    for codec in ("exact", "flag", "int8_ef"):
        for lanes in (0, 1, 127, 128, 129, 1000):
            assert tdist._wire_bytes(codec, lanes, 4) == jdist._wire_bytes(
                codec, lanes, 4)
    with pytest.raises(ValueError, match="unknown boundary codec"):
        tdist._encode("fp8", torch.zeros(1, 1), torch.zeros(1, 1), 0.0)


# ---------------------------------------------------------------------------
# P = 1 against the reference's partitioned pipeline (one JAX device)
# ---------------------------------------------------------------------------

def _pipes(graphs, name, app, mode, compress):
    """Both packages' ``PartitionedFrontierPipeline`` at P = 1 on the same
    partition, multi-rung ladder, app and mode."""
    jg, _ = graphs[name]
    jpart = jcsr.partition_csr(jg, 1)
    tpart = partition_from_numpy(jpart, "cpu")
    kw = {"pagerank": dict(iters=5)}.get(app, {})
    iters = kw.get("iters")
    jp = jdist.PartitionedFrontierPipeline(
        jpart, getattr(jdist, f"partitioned_{app}_app")(jpart, **kw),
        mode=mode, compress=compress, max_iters=iters,
        capacity_policy=JPolicy(**ONE_SHARD_LADDER))
    tp = tdist.PartitionedFrontierPipeline(
        tpart, getattr(tdist, f"partitioned_{app}_app")(tpart, **kw),
        mode=mode, compress=compress, max_iters=iters,
        capacity_policy=TPolicy(**ONE_SHARD_LADDER), device="cpu")
    return jp, tp


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("app", ["bfs", "sssp", "pagerank"])
def test_single_shard_matches_reference_partitioned(graphs, app, mode):
    jp, tp = _pipes(graphs, "kron", app, mode, compress=True)
    want, got = np.asarray(jp.run(0)), n(tp.run(0))
    if app == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        assert np.array_equal(got, want)
    assert (tp.supersteps, tp.n_hops, tp.buckets) == (
        jp.supersteps, jp.n_hops, jp.buckets)
    assert len(tp.buckets) == 2
    assert tp.n_hops == 1 if app == "pagerank" else tp.n_hops > 1
    assert tp.boundary_traffic() == jp.boundary_traffic()


def test_single_shard_wrappers_match_reference(graphs, single_device):
    jg, tg = graphs["delaunay"]
    ref_b, ref_s, ref_p = single_device["delaunay"]
    assert np.array_equal(n(tdist.bfs_partitioned(tg, 0, n_parts=1,
                                                  device="cpu")),
                          jdist.bfs_partitioned(jg, 0, n_parts=1))
    assert np.array_equal(n(tdist.sssp_partitioned(tg, 0, device="cpu")),
                          ref_s)
    got = n(tdist.pagerank_partitioned(tg, n_parts=1, iters=5,
                                       device="cpu"))
    np.testing.assert_allclose(got, ref_p, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        got, jdist.pagerank_partitioned(jg, n_parts=1, iters=5),
        rtol=1e-5, atol=1e-7)
    assert np.array_equal(n(tdist.bfs_partitioned(
        tcsr.partition_csr(tg, 1), 0, device="cpu")), ref_b)


# ---------------------------------------------------------------------------
# P = 2 and 4 against the reference's single-device pipelines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_parts", [2, 4])
@pytest.mark.parametrize("name", ["kron", "delaunay"])
def test_partitioned_matches_single_device(graphs, single_device, name,
                                           n_parts, mode, compress):
    _, tg = graphs[name]
    ref_b, ref_s, ref_p = single_device[name]
    part = tcsr.partition_csr(tg, n_parts)
    kw = dict(mode=mode, compress=compress, device="cpu")
    assert np.array_equal(n(tdist.bfs_partitioned(part, 0, **kw)), ref_b)
    assert np.array_equal(n(tdist.sssp_partitioned(part, 0, **kw)), ref_s)
    tol = 2e-3 if compress else 1e-4
    np.testing.assert_allclose(
        n(tdist.pagerank_partitioned(part, iters=5, **kw)), ref_p,
        rtol=tol, atol=tol)


def test_bucketed_compressed_bfs_hops(graphs, single_device):
    """Compressed BFS under a multi-rung ladder in hash mode stays
    bit-identical while it hops rungs (delaunay: many levels)."""
    _, tg = graphs["delaunay"]
    part = tcsr.partition_csr(tg, 4)
    pipe = tdist.PartitionedFrontierPipeline(
        part, tdist.partitioned_bfs_app(part), mode="hash", compress=True,
        capacity_policy=TPolicy(n_buckets=3, min_capacity=16), device="cpu")
    assert np.array_equal(n(pipe.run(0)), single_device["delaunay"][0])
    assert pipe.n_hops > 1
    traffic = pipe.boundary_traffic()
    assert traffic["codec"] == "flag" and traffic["reduction"] == 4.0
    assert traffic["supersteps"] == pipe.supersteps > 1


def test_flag_codec_needs_every_shard_in_lockstep(graphs, single_device):
    """BFS's flag codec rebuilds a lane from the receiver's depth: a shard
    whose frontier is empty still advances it every superstep (a run from a
    source whose shard empties first)."""
    _, tg = graphs["kron"]
    part = tcsr.partition_csr(tg, 4)
    source = tg.n_nodes - 1  # the last shard's
    pipe = tdist.PartitionedFrontierPipeline(
        part, tdist.partitioned_bfs_app(part), compress=True, device="cpu")
    got = n(pipe.run(source))
    assert np.array_equal(got, n(bfs_pipeline(graphs["kron"][0], source)))
    assert np.array_equal(n(pipe._state["depth"]),
                          np.full(4, pipe.supersteps, np.int32))


def test_pipeline_rejects_unknown_mode(graphs):
    part = tcsr.partition_csr(graphs["kron"][1], 2)
    with pytest.raises(ValueError, match="baseline|sort|hash"):
        tdist.PartitionedFrontierPipeline(
            part, tdist.partitioned_bfs_app(part), mode="hash_ref",
            device="cpu")


# ---------------------------------------------------------------------------
# P = 4 against the reference on four forced JAX host devices
# ---------------------------------------------------------------------------

_CHILD = """
import json
import numpy as np
from repro.core import CapacityPolicy
from repro.dist.graph_partition import (
    PartitionedFrontierPipeline, partitioned_bfs_app,
    partitioned_pagerank_app)
from repro.graphs.csr import partition_csr
from repro.graphs.generators import kron
part = partition_csr(kron(scale=7, edge_factor=8, seed=4), 4)
out = {}
pipe = PartitionedFrontierPipeline(
    part, partitioned_bfs_app(part), compress=True,
    capacity_policy=CapacityPolicy(**LADDER))
out["bfs"] = np.asarray(pipe.run(0)).tolist()
out["bfs_hops"], out["bfs_steps"] = pipe.n_hops, pipe.supersteps
out["bfs_traffic"] = pipe.boundary_traffic()
for iters in (1, 5):
    pipe = PartitionedFrontierPipeline(
        part, partitioned_pagerank_app(part, iters=iters), compress=True,
        max_iters=iters)
    out[f"pr{iters}"] = np.asarray(pipe.run(0)).tolist()
    out[f"pr{iters}_traffic"] = pipe.boundary_traffic()
print(json.dumps(out))
"""


def test_four_shards_match_reference_on_four_devices(graphs):
    """The reference at P = 4 on four forced host devices: compressed BFS
    under a 3-rung ladder (labels, ``n_hops``, ``supersteps``, traffic) and
    compressed PageRank after 1 and 5 supersteps.  The port's ``int8_ef``
    trajectory follows the reference's within rtol 1e-5: both quantize the
    same values to the same int8 codes, so only f32 sum order differs (one
    flipped code would move a lane by about 1/127 of its block's max)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    code = f"LADDER = {LADDER!r}\n" + textwrap.dedent(_CHILD)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    part = tcsr.partition_csr(graphs["kron"][1], 4)
    pipe = tdist.PartitionedFrontierPipeline(
        part, tdist.partitioned_bfs_app(part), compress=True,
        capacity_policy=TPolicy(**LADDER), device="cpu")
    assert n(pipe.run(0)).tolist() == want["bfs"]
    assert (pipe.n_hops, pipe.supersteps) == (want["bfs_hops"],
                                              want["bfs_steps"])
    assert want["bfs_hops"] > 1
    assert pipe.boundary_traffic() == want["bfs_traffic"]
    for iters in (1, 5):
        pipe = tdist.PartitionedFrontierPipeline(
            part, tdist.partitioned_pagerank_app(part, iters=iters),
            compress=True, max_iters=iters, device="cpu")
        got = n(pipe.run(0))
        np.testing.assert_allclose(got, np.float32(want[f"pr{iters}"]),
                                   rtol=1e-5, atol=0)
        assert pipe.boundary_traffic() == want[f"pr{iters}_traffic"]

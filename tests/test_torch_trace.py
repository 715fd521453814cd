"""Port parity: the paper-figure instrumentation against the JAX package.

The same seeded inputs go through ``repro`` and ``repro_torch``:

* ``core.coalescing`` -- ``accesses_per_group`` and its reductions on
  seeded streams (with and without active masks, ragged tails, all-inactive
  groups, 4- and 8-byte elements): equal, the counts' dtype int32;
* ``core.costmodel`` -- ``simulate_trace``, ``cycles``, ``energy_pj`` and
  ``Comparison.report`` on seeded traces, atomic and not: every count and
  every float equal;
* ``graphs.generators`` -- all six datasets at the harness's quick sizes:
  CSR arrays bit-identical;
* the host apps in ``"iru"`` mode through ``reorder_frontier`` with the
  paper's geometry (``IRU_HASH``), the port's ``hash_ref`` and ``hash``
  (its plain engine here) against the reference's ``hash_ref``, and in
  baseline mode: events (indices, active, atomic) and ``iru_elements``
  bit-identical, BFS and SSSP results equal, PageRank within rtol 1e-5;
* ``FrontierPipeline.run_instrumented`` in baseline, sort and hash (a small
  banked, windowed geometry; one and three capacity buckets) against the
  reference's ``run_instrumented``: the same events, ``iru_elements`` and
  result (PageRank within rtol 1e-5);
* ``bfs_jit`` and ``pagerank_jit`` against the reference's (BFS exactly,
  PageRank at ``tests/test_graph_apps.py``'s rtol 1e-4, atol 1e-7).
"""
from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps.trace import TraceRecorder as JRecorder
from repro.core import coalescing as jco
from repro.core import costmodel as jcm
from repro.core import pipeline as jpipe
from repro.core.iru import IRUConfig as JConfig
from repro.graphs import csr as jcsr
from repro.graphs import generators as jgen
from repro_torch.apps.trace import TraceRecorder
from repro_torch.core import coalescing as tco
from repro_torch.core import costmodel as tcm
from repro_torch.core import pipeline as tpipe
from repro_torch.core.iru import IRUConfig
from repro_torch.graphs import csr as tcsr
from repro_torch.graphs import generators as tgen
from torch_parity import jax_graph_to_torch, n, t

# the packages' ``apps`` re-export functions under their modules' names
jbfs, jsssp, jpr = (importlib.import_module(f"repro.apps.{m}")
                    for m in ("bfs", "sssp", "pagerank"))
tbfs, tsssp, tpr = (importlib.import_module(f"repro_torch.apps.{m}")
                    for m in ("bfs", "sssp", "pagerank"))

IRU_HASH = dict(num_sets=1024, slots=32, window_elems=8192, n_partitions=4,
                n_banks=2, round_cap=64)
QUICK_DATASET_KW = {"ca": dict(scale=32), "cond": dict(n=2_000),
                    "delaunay": dict(scale=32), "human": dict(n=800),
                    "kron": dict(scale=10), "msdoor": dict(scale=10)}


# -- coalescing ------------------------------------------------------------

def _stream(case: str, length: int, rng):
    """Seeded index stream and active mask (None = all lanes active)."""
    idx = rng.integers(0, 5000, length).astype(np.int32)
    if case == "sorted":
        idx = np.sort(idx)
    if case in ("none", "sorted"):
        return idx, None
    act = rng.random(length) < 0.6
    if case == "dead_groups":   # whole groups of 32 with no active lane
        act[32:96] = False
    if case == "all_dead":
        act[:] = False
    return idx, act


# the reference's functions, each compiled once a shape (run op by op, a
# case costs seconds of compiles)
_JCO = {name: jax.jit(getattr(jco, name), static_argnames=("elem_bytes",))
        for name in ("accesses_per_group", "total_accesses",
                     "mean_accesses_per_group")}
_JCO["coalescing_improvement"] = jax.jit(
    jco.coalescing_improvement, static_argnames=("elem_bytes",))


@pytest.mark.parametrize("case,length,elem_bytes", [
    ("none", 1, 4), ("none", 64, 8), ("sorted", 300, 4), ("mask", 77, 8),
    ("dead_groups", 200, 4), ("all_dead", 45, 8)])
def test_coalescing_counts_match_reference(case, length, elem_bytes):
    rng = np.random.default_rng(length * 10 + elem_bytes)
    idx, act = _stream(case, length, rng)
    base = rng.integers(0, 5000, length).astype(np.int32)
    kw = dict(elem_bytes=elem_bytes)
    jidx = jnp.asarray(idx)
    jact = None if act is None else jnp.asarray(act)
    tact = None if act is None else t(act)
    want = np.asarray(_JCO["accesses_per_group"](jidx, jact, **kw))
    got = tco.accesses_per_group(t(idx), tact, **kw)
    assert got.dtype == torch.int32 and np.array_equal(n(got), want)
    assert int(tco.total_accesses(t(idx), tact, **kw)) == int(
        _JCO["total_accesses"](jidx, jact, **kw))
    assert float(tco.mean_accesses_per_group(t(idx), tact, **kw)) == float(
        _JCO["mean_accesses_per_group"](jidx, jact, **kw))
    assert float(tco.coalescing_improvement(t(base), t(idx), tact, **kw)) \
        == float(_JCO["coalescing_improvement"](jnp.asarray(base), jidx,
                                                jact, **kw))
    # numpy in, as the harness's reference passes it
    assert np.array_equal(n(tco.accesses_per_group(idx, act, **kw)), want)


def test_coalescing_counts_an_all_inactive_group_zero():
    idx = np.arange(64, dtype=np.int32) * 32   # every lane its own block
    act = np.zeros(64, bool)
    act[:32] = True
    got = n(tco.accesses_per_group(t(idx), t(act)))
    assert got.tolist() == [32, 0]
    assert float(tco.mean_accesses_per_group(t(idx), t(act))) == 32.0
    with pytest.raises(ValueError, match="must divide"):
        tco.elems_per_block(48)


# -- cost model --------------------------------------------------------------

def _trace(seed: int, atomic: bool, n_events: int = 6):
    rng = np.random.default_rng(seed)
    events = []
    for e in range(n_events):
        length = int(rng.integers(1, 900))
        idx = rng.integers(0, 40_000, length).astype(np.int32)
        if e % 3 == 1:
            idx = np.sort(idx)
        act = None if e % 2 == 0 else rng.random(length) < 0.7
        events.append((idx, act, atomic if e % 4 else not atomic))
    return events


SMALL_GPU = dict(num_sms=4, l1_bytes=4096, l2_bytes=64 * 1024)


@pytest.mark.parametrize("gpu", [{}, SMALL_GPU], ids=["gtx980", "small"])
@pytest.mark.parametrize("atomic", [False, True])
def test_cost_model_matches_reference(atomic, gpu):
    jgpu, tgpu = jcm.GPUConfig(**gpu), tcm.GPUConfig(**gpu)
    base_ev, iru_ev = _trace(1, atomic), _trace(2, atomic)
    jb = jcm.simulate_trace(base_ev, gpu=jgpu)
    ji = jcm.simulate_trace(iru_ev, gpu=jgpu, iru_processed=1234)
    tb = tcm.simulate_trace(base_ev, gpu=tgpu)
    ti = tcm.simulate_trace(iru_ev, gpu=tgpu, iru_processed=1234)
    for j, p in ((jb, tb), (ji, ti)):
        assert dataclasses.astuple(p) == dataclasses.astuple(j)
        assert tcm.cycles(p, tgpu) == jcm.cycles(j, jgpu)
        assert tcm.energy_pj(p, tgpu) == jcm.energy_pj(j, jgpu)
    assert dataclasses.astuple(tb + ti) == dataclasses.astuple(jb + ji)
    assert (tcm.Comparison("c", tb, ti).report(tgpu)
            == jcm.Comparison("c", jb, ji).report(jgpu))
    assert tb.l1_accesses + tb.l2_accesses > 0


# -- generators ----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(QUICK_DATASET_KW))
def test_generators_match_reference(name):
    kw = QUICK_DATASET_KW[name]
    want = jgen.make_dataset(name, **kw)
    got = tgen.make_dataset(name, device="cpu", **kw)
    assert got.n_nodes == want.n_nodes and got.n_edges == want.n_edges > 0
    for field in ("row_ptr", "col_idx", "weights"):
        a, b = n(getattr(got, field)), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field


def test_make_dataset_unknown_name_raises_as_reference():
    with pytest.raises(KeyError) as want:
        jgen.make_dataset("roadnet")
    with pytest.raises(KeyError) as got:
        tgen.make_dataset("roadnet", device="cpu")
    assert str(got.value) == str(want.value)


# -- host apps -------------------------------------------------------------

def _assert_same_trace(got: TraceRecorder, want: JRecorder) -> None:
    assert got.iru_elements == want.iru_elements
    assert len(got.events) == len(want.events) > 0
    for (gi, ga, gat), (wi, wa, wat) in zip(got.events, want.events):
        gi, wi = np.asarray(gi), np.asarray(wi)
        assert gi.dtype == wi.dtype and np.array_equal(gi, wi)
        assert (ga is None) == (wa is None)
        if ga is not None:
            assert np.array_equal(ga, np.asarray(wa, bool))
        assert gat == wat


def _assert_same_result(algo: str, got, want) -> None:
    got, want = n(got), np.asarray(want)
    if algo == "pr":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.fixture(scope="module")
def kron_quick():
    return jgen.kron(scale=10)


def _weighted(scale=8, seed=7):
    """A seeded kron graph with weights in [1, 64) (SSSP's rounds then
    re-relax nodes), built by both packages."""
    src, dst, n_nodes = tgen.kron_edges(scale, 8, seed)
    w = np.random.default_rng(seed).uniform(1.0, 64.0, src.shape[0])
    w = w.astype(np.float32)
    return (jcsr.from_edges(src, dst, n_nodes, w, symmetrize=True),
            tcsr.from_edges(src, dst, n_nodes, w, symmetrize=True,
                            device="cpu"))


HOST = {"bfs": (jbfs.bfs, tbfs.bfs, None, dict()),
        "sssp": (jsssp.sssp, tsssp.sssp, "min", dict()),
        "pr": (jpr.pagerank, tpr.pagerank, "add", dict(iters=3))}


@pytest.mark.parametrize("engine", ["baseline", "hash_ref", "hash"])
@pytest.mark.parametrize("algo", ["bfs", "sssp", "pr"])
def test_host_apps_trace_matches_reference(kron_quick, algo, engine):
    jfn, tfn, op, kw = HOST[algo]
    jg = kron_quick
    tg = jax_graph_to_torch(jg)
    src = () if algo == "pr" else (0,)
    jrec, trec = JRecorder(), TraceRecorder()
    if engine == "baseline":
        want = jfn(jg, *src, recorder=jrec, **kw)
        got = tfn(tg, *src, recorder=trec, device="cpu", **kw)
    else:
        want = jfn(jg, *src, mode="iru", recorder=jrec, **kw,
                   iru_config=JConfig(mode="hash_ref", filter_op=op,
                                      **IRU_HASH))
        got = tfn(tg, *src, mode="iru", recorder=trec, device="cpu", **kw,
                  iru_config=IRUConfig(mode=engine, filter_op=op,
                                       **IRU_HASH))
    _assert_same_trace(trec, jrec)
    _assert_same_result(algo, got, want)


@pytest.mark.parametrize("engine", ["hash_ref", "hash"])
def test_host_sssp_with_weights_matches_reference(engine):
    """Weighted SSSP re-relaxes nodes over many rounds; a small banked,
    windowed geometry merges within each 512-lane window."""
    jg, tg = _weighted()
    geo = dict(num_sets=64, slots=8, window_elems=512, n_partitions=2)
    jrec, trec = JRecorder(), TraceRecorder()
    want = jsssp.sssp(jg, 0, mode="iru", recorder=jrec,
                      iru_config=JConfig(mode="hash_ref", filter_op="min",
                                         **geo))
    got = tsssp.sssp(tg, 0, mode="iru", recorder=trec, device="cpu",
                     iru_config=IRUConfig(mode=engine, filter_op="min",
                                          **geo))
    _assert_same_trace(trec, jrec)
    assert np.array_equal(got, want) and len(trec.events) > 3


# -- run_instrumented ----------------------------------------------------------

# the hash engine's geometries: the paper's kind (banked partitions,
# windows) at a small size, and a flat table (it compiles in a fraction of
# the time in the reference)
WINDOWED = dict(num_sets=64, slots=8, window_elems=256, n_partitions=2)
FLAT = dict(num_sets=64, slots=8)
PIPE_APPS = {"bfs": (jbfs.BFS_APP, tbfs.BFS_APP, None),
             "sssp": (jsssp.SSSP_APP, tsssp.SSSP_APP, None),
             "pr": (jpr.pagerank_app(3), tpr.pagerank_app(3), 3)}


@pytest.mark.parametrize("algo,mode,geo,buckets", [
    (algo, mode, None, 1) for algo in ("bfs", "sssp", "pr")
    for mode in ("baseline", "sort")]
    + [("pr", "hash", WINDOWED, 1), ("bfs", "hash", FLAT, 2),
       ("sssp", "hash", FLAT, 1)],
    ids=lambda v: ("windowed" if v is WINDOWED else "flat" if v is FLAT
                   else None))
def test_run_instrumented_matches_reference(algo, mode, geo, buckets):
    """(PageRank's all-nodes frontier always takes the top rung, so it has
    no bucketed case of its own.)"""
    jg, tg = _weighted()
    japp, tapp, iters = PIPE_APPS[algo]
    jkw = dict(mode=mode, max_iters=iters)
    tkw = dict(jkw)
    if buckets > 1:
        jkw["capacity_policy"] = jpipe.CapacityPolicy(
            n_buckets=buckets, min_capacity=64, growth=4)
        tkw["capacity_policy"] = tpipe.CapacityPolicy(
            n_buckets=buckets, min_capacity=64, growth=4)
    if geo is not None:
        jkw["iru_config"] = JConfig(**geo)
        tkw["iru_config"] = IRUConfig(**geo)
    jrec, trec = JRecorder(), TraceRecorder()
    want = jpipe.FrontierPipeline(jg, japp, **jkw).run_instrumented(
        0, recorder=jrec)
    pipe = tpipe.FrontierPipeline(tg, tapp, device="cpu", **tkw)
    got = pipe.run_instrumented(0, recorder=trec)
    if mode == "baseline":
        assert trec.iru_elements == 0
    _assert_same_trace(trec, jrec)
    _assert_same_result(algo, got, want)
    # the trace carries exactly the run's accesses, every event its live
    # edges; outside baseline they all went through the IRU
    lanes = sum(len(i) for i, _, _ in trec.events)
    assert mode == "baseline" or lanes == trec.iru_elements
    # run() takes the same path to the same result
    _assert_same_result(algo, got, pipe.run(0))


def test_pipeline_wrappers_take_a_recorder():
    _, tg = _weighted()
    for fn, args in ((tbfs.bfs_pipeline, (0,)), (tsssp.sssp_pipeline, (0,)),
                     (tpr.pagerank_pipeline, ())):
        kw = dict(iters=2) if fn is tpr.pagerank_pipeline else {}
        rec = TraceRecorder()
        got = fn(tg, *args, mode="sort", recorder=rec, device="cpu", **kw)
        plain = fn(tg, *args, mode="sort", device="cpu", **kw)
        assert torch.equal(got, plain) and rec.events and rec.iru_elements
        atomic = fn is not tbfs.bfs_pipeline
        assert all(a is atomic for _, _, a in rec.events)


# -- dense whole-run apps -----------------------------------------------------------

def test_bfs_jit_matches_reference():
    jg, tg = _weighted()
    want = np.asarray(jbfs.bfs_jit(jg, 0))
    got = tbfs.bfs_jit(tg, 0, device="cpu")
    assert np.array_equal(n(got), want)
    assert np.array_equal(n(got), tbfs.bfs(tg, 0))
    capped = tbfs.bfs_jit(tg, 0, max_iters=2, device="cpu")
    assert np.array_equal(n(capped), np.asarray(jbfs.bfs_jit(jg, 0,
                                                             max_iters=2)))


@pytest.mark.parametrize("use_iru", [True, False])
def test_pagerank_jit_matches_reference(use_iru):
    jg, tg = _weighted()
    want = np.asarray(jpr.pagerank_jit(
        jg.edge_sources(), jg.col_idx, jg.degrees(), jg.n_nodes, iters=10,
        use_iru=use_iru))
    got = tpr.pagerank_jit(tg.edge_sources(), tg.col_idx, tg.degrees(),
                           tg.n_nodes, iters=10, use_iru=use_iru,
                           device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), want, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(n(got), tpr.pagerank(tg, iters=10),
                               rtol=1e-4, atol=1e-7)

"""Port parity: the multi-tenant graph serving engine (``serve``), its graph
views (``tile_csr``, ``GraphView``) and fault vocabulary (``ft``) against
``repro.serve.graph_engine``, ``repro.graphs.csr`` and ``repro.ft``.

Both engines serve the same graph and the same queries; every case compares
each query's status, retries, error and result, and the engines'
``overflow_events``, ``quarantines`` and ``admission_blocked`` counts.  BFS
labels and SSSP distances are bit-identical; PPR ranks are held to rtol 1e-5
(+ atol 1e-7 near zero), since the port sums each rank's contributions in
another order (the reference's own fused PPR differs from its solo runs by
1.49e-8 on one entry).  The cases mirror ``tests/test_graph_serving.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro import ft as jft
from repro import serve as jserve
from repro.core.pipeline import CapacityPolicy as JPolicy
from repro.graphs import csr as jcsr
from repro.graphs.generators import delaunay as jdelaunay
from repro.graphs.generators import kron as jkron
from repro_torch import ft as tft
from repro_torch import serve as tserve
from repro_torch.convert import view_from_numpy
from repro_torch.core.pipeline import CapacityPolicy as TPolicy
from repro_torch.graphs import csr as tcsr
from repro_torch.graphs.generators import delaunay as tdelaunay
from repro_torch.graphs.generators import kron as tkron
from torch_parity import n

SMALL = dict(n_buckets=2, min_capacity=256, growth=16)


@pytest.fixture(scope="module")
def gk():
    return jkron(scale=7, edge_factor=8, seed=4), tkron(
        scale=7, edge_factor=8, seed=4, device="cpu")


@pytest.fixture(scope="module")
def gd():
    return jdelaunay(scale=48, seed=2), tdelaunay(scale=48, device="cpu")


def _mixed(pkg, sources=(0, 3, 9, 17)):
    Q, s = pkg.GraphQuery, list(sources)
    return [Q("bfs", s[0]), Q("sssp", s[1]), Q("ppr", s[2], iters=8),
            Q("bfs", s[3]), Q("ppr", s[0], iters=5), Q("sssp", s[2])]


def _engines(graphs, queries, *, plan=None, policy=SMALL, patch=None,
             max_ticks=2000, **cfg):
    """Both engines on the same graph, config, fault plan and queries, each
    run to completion.  ``queries(pkg)`` builds one package's query list;
    ``patch(engine)`` may wrap an engine before it runs."""
    out = []
    for pkg, ft, policy_cls, g, kw in (
            (jserve, jft, JPolicy, graphs[0], {}),
            (tserve, tft, TPolicy, graphs[1], {"device": "cpu"})):
        eng = pkg.GraphServingEngine(
            g, pkg.GraphServeConfig(capacity_policy=policy_cls(**policy),
                                    **cfg),
            fault_plan=None if plan is None else ft.QueryFaultPlan(**plan),
            **kw)
        if patch is not None:
            patch(eng)
        qs = queries(pkg)
        for q in qs:
            eng.submit(q)
        eng.run_to_completion(max_ticks)
        out.append((eng, qs))
    _assert_same(*out)
    return out


def _assert_same(want, got):
    (je, jq), (te, tq) = want, got
    assert (te.overflow_events, te.quarantines, te.admission_blocked) == (
        je.overflow_events, je.quarantines, je.admission_blocked)
    for a, b in zip(jq, tq):
        assert (b.qid, b.status, b.retries) == (a.qid, a.status, a.retries), (
            a.kind, a.error, b.error)
        if a.error is None or "straggler" in a.error:  # wall-clock figures
            assert (b.error is None) == (a.error is None)
        else:
            assert b.error == a.error
        if a.result is None:
            assert b.result is None
            continue
        assert b.result.dtype == a.result.dtype
        if a.kind == "ppr":
            np.testing.assert_allclose(b.result, a.result, rtol=1e-5,
                                       atol=1e-7)
        else:
            assert np.array_equal(b.result, a.result), (a.kind, a.source)


def _assert_solo(eng, queries):
    """Every done query equals its solo pipeline run, bit for bit."""
    for q in queries:
        assert q.status == "done", (q.qid, q.status, q.error)
        assert np.array_equal(q.result, eng.solo_reference(q))


# ---------------------------------------------------------------------------
# graph views
# ---------------------------------------------------------------------------

def test_tile_csr_and_view_match_reference(gk):
    jg, tg = gk
    jv, tv = jcsr.tile_csr(jg, 3), tcsr.tile_csr(tg, 3)
    for _ in range(2):  # a view, then a view of the view: tenants multiply
        assert isinstance(tv, tcsr.GraphView)
        assert (tv.n_tenants, tv.base_nodes, tv.base_edges) == (
            jv.n_tenants, jv.base_nodes, jv.base_edges)
        for field in ("row_ptr", "col_idx", "weights"):
            want = np.asarray(getattr(jv, field))
            assert np.array_equal(n(getattr(tv, field)), want)
            assert n(getattr(tv, field)).dtype == want.dtype
        for field in ("row_ptr", "col_idx", "weights"):
            assert np.array_equal(n(getattr(tv.base, field)),
                                  np.asarray(getattr(jv.base, field)))
        ids = np.arange(tv.n_nodes, dtype=np.int32)
        assert np.array_equal(n(tv.tenant_of(torch.from_numpy(ids))),
                              np.asarray(jv.tenant_of(ids)))
        assert np.array_equal(n(tv.local_of(torch.from_numpy(ids))),
                              np.asarray(jv.local_of(ids)))
        moved = tv.to("cpu")
        assert isinstance(moved, tcsr.GraphView)
        assert moved.n_tenants == tv.n_tenants
        jv, tv = jcsr.tile_csr(jv, 2), tcsr.tile_csr(tv, 2)
    assert tv.n_tenants == 12 and tv.base_nodes == tg.n_nodes
    # the reference's view carried across through convert
    carried = view_from_numpy(np.asarray(jv.row_ptr), np.asarray(jv.col_idx),
                              np.asarray(jv.weights), n_tenants=jv.n_tenants,
                              base_nodes=jv.base_nodes,
                              base_edges=jv.base_edges, device="cpu")
    for field in ("row_ptr", "col_idx", "weights"):
        assert np.array_equal(n(getattr(carried, field)),
                              n(getattr(tv, field)))
    assert (carried.n_tenants, carried.base_nodes, carried.base_edges) == (
        tv.n_tenants, tv.base_nodes, tv.base_edges)


@pytest.mark.parametrize("copies", ["zero", "nodes", "edges"])
def test_tile_csr_rejects_what_the_reference_rejects(gk, copies):
    """The id-space check runs before anything is allocated, with the
    reference's message (edge offsets overflow before node ids)."""
    jg, tg = gk
    c = {"zero": 0, "nodes": 2**31 // jg.n_nodes + 1,
         "edges": 2**31 // jg.n_edges + 1}[copies]
    with pytest.raises(ValueError) as want:
        jcsr.tile_csr(jg, c)
    with pytest.raises(ValueError) as got:
        tcsr.tile_csr(tg, c)
    assert str(got.value) == str(want.value)
    if copies == "edges":
        assert c * jg.n_nodes < 2**31  # the node space alone would pass
        assert f"copies={c}" in str(got.value) and "int32" in str(got.value)


# ---------------------------------------------------------------------------
# multiplexing parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bfs", "sssp", "ppr"])
def test_single_query_matches_reference(gk, kind):
    (_, _), (te, tq) = _engines(
        gk, lambda pkg: [pkg.GraphQuery(kind, 5, iters=6)], query_slots=2)
    _assert_solo(te, tq)


@pytest.mark.parametrize("mode", ["baseline", "sort", "hash"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_mixed_queries_match_reference(gk, mode, fused):
    """The tagged datapath (fused) and the per-family one (split) in each
    reorder mode: B2's tagged body and B3's tagged fold on the card."""
    (_, _), (te, tq) = _engines(gk, _mixed, query_slots=4, mode=mode,
                                fused=fused)
    for q in tq:  # the min family stays bit-identical to solo runs
        if q.kind != "ppr":
            _assert_solo(te, [q])


def test_mixed_queries_on_high_diameter_graph(gd):
    (_, _), (te, tq) = _engines(gd, _mixed, query_slots=4)
    _assert_solo(te, [q for q in tq if q.kind != "ppr"])


def test_more_queries_than_slots(gk):
    def queries(pkg):
        return ([pkg.GraphQuery("bfs", i * 7 % 128) for i in range(9)]
                + [pkg.GraphQuery("ppr", 3, iters=4)])

    (_, _), (te, tq) = _engines(gk, queries, query_slots=2)
    _assert_solo(te, tq[:-1])


def test_fused_engine_accepts_composed_view(gk):
    jg, tg = gk
    views = (jcsr.tile_csr(jg, 4), tcsr.tile_csr(tg, 4))
    _engines(views, _mixed, query_slots=4)
    with pytest.raises(ValueError, match="n_tenants"):
        tserve.GraphServingEngine(views[1], tserve.GraphServeConfig(
            query_slots=5), device="cpu")


def test_partitioned_view_waits_for_its_slice(gk):
    pview = jcsr.partition_csr(jcsr.tile_csr(gk[0], 2), 1)
    for fused in (True, False):
        with pytest.raises(NotImplementedError, match="partitioned"):
            tserve.GraphServingEngine(pview, tserve.GraphServeConfig(
                query_slots=2, fused=fused), device="cpu")


def test_config_has_one_kernels_switch():
    """The reference's per-stage ``gather`` is the port's ``kernels``."""
    assert tserve.GraphServeConfig().kernels is True
    with pytest.raises(TypeError):
        tserve.GraphServeConfig(gather="xla")
    want = {f.name for f in jserve.GraphServeConfig.__dataclass_fields__
            .values()} - {"gather"}
    got = set(tserve.GraphServeConfig.__dataclass_fields__) - {"kernels"}
    assert got == want


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def test_submit_rejects_what_the_reference_rejects(gk):
    cases = [dict(q=("wcc", 0)), dict(q=("bfs", -1)), dict(q=("bfs", 128)),
             dict(q=("ppr", 0), edge_capacity=gk[0].n_edges // 2)]
    for case in cases:
        errors = []
        for pkg, g, kw in ((jserve, gk[0], {}),
                           (tserve, gk[1], {"device": "cpu"})):
            eng = pkg.GraphServingEngine(g, pkg.GraphServeConfig(
                query_slots=2, edge_capacity=case.get("edge_capacity")), **kw)
            with pytest.raises(pkg.AdmissionError) as e:
                eng.submit(pkg.GraphQuery(*case["q"]))
            errors.append(str(e.value))
        assert errors[1] == errors[0]


def test_bounded_queue_overflows_loudly(gk):
    eng = tserve.GraphServingEngine(gk[1], tserve.GraphServeConfig(
        query_slots=1, max_queue=2), device="cpu")
    eng.submit(tserve.GraphQuery("bfs", 0))
    eng.submit(tserve.GraphQuery("bfs", 1))
    with pytest.raises(tserve.QueueFullError, match="shed load"):
        eng.submit(tserve.GraphQuery("bfs", 2))


def test_admission_gate_delays_join(gk):
    def queries(pkg):
        return [pkg.GraphQuery("ppr", 0, iters=6),
                pkg.GraphQuery("ppr", 5, iters=6)]

    (_, jq), (te, tq) = _engines(
        gk, queries, query_slots=2, edge_capacity=int(1.5 * gk[0].n_edges))
    assert te.admission_blocked > 0
    assert [q.admitted_tick for q in tq] == [q.admitted_tick for q in jq]


# ---------------------------------------------------------------------------
# overflow quarantine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_injected_overflow_quarantines_and_recovers(gk, fused):
    (_, _), (te, tq) = _engines(
        gk, _mixed, plan=dict(overflow_at=(3,)), query_slots=4,
        backoff_base_s=0.001, fused=fused,
        max_ticks=10**6)  # idle ticks may outrun the backoff
    assert ("overflow", 3) in te.injector.fired
    assert te.quarantines >= 1 and any(q.retries for q in tq)
    _assert_solo(te, [q for q in tq if q.kind != "ppr"])


def test_capacity_pressure_evicts_and_recovers(gk):
    def queries(pkg):
        return [pkg.GraphQuery("bfs", s) for s in (0, 3, 9, 17, 33, 64)]

    (_, _), (te, tq) = _engines(
        gk, queries, query_slots=4, edge_capacity=int(1.3 * gk[0].n_edges),
        backoff_base_s=0.001,
        policy=dict(n_buckets=3, min_capacity=64, growth=8),
        max_ticks=10**6)  # idle ticks may outrun the backoff
    assert te.overflow_events > 0 and te.quarantines > 0
    _assert_solo(te, tq)


def test_step_overflow_flag_quarantines_without_committing(gk):
    """A gate that lies ("everyone fits"): the step's own overflow flag
    still catches it, and nothing truncated is committed."""
    def lie(eng):
        real = eng._family_load
        eng._family_load = lambda fam: np.minimum(real(fam), 1)

    def queries(pkg):
        return [pkg.GraphQuery("bfs", s) for s in (0, 3, 9, 17)]

    (_, _), (te, tq) = _engines(
        gk, queries, patch=lie, query_slots=4,
        edge_capacity=int(1.2 * gk[0].n_edges), backoff_base_s=0.001,
        policy=dict(n_buckets=2, min_capacity=64, growth=8),
        max_ticks=10**6)  # idle ticks may outrun the backoff
    assert te.overflow_events > 0
    _assert_solo(te, tq)


def test_quarantine_retries_are_bounded(gk):
    (_, _), (_, tq) = _engines(
        gk, lambda pkg: [pkg.GraphQuery("ppr", 0, iters=50, tick_budget=2)],
        plan=dict(overflow_at=(1,)), query_slots=1, backoff_base_s=0.001,
        max_retries=2, max_ticks=10**6)  # idle ticks outrun the backoff
    assert tq[0].status == "failed" and tq[0].retries > 2
    assert "exhausted 2 quarantine retries" in tq[0].error


def test_backoff_and_straggler_clock_match_reference():
    for base, attempt in ((0.1, 0), (0.1, 1), (0.1, 3), (0.01, 7)):
        assert tft.backoff_delay(base, attempt) == jft.backoff_delay(
            base, attempt)
    clocks = (jft.StragglerClock(3.0, 0.9), tft.StragglerClock(3.0, 0.9))
    assert clocks[1].deadline() is None
    for dt in (1.0, 100.0, 2.0, 0.5):
        assert clocks[1].observe(dt) == clocks[0].observe(dt)
        assert clocks[1].avg == clocks[0].avg
        for floor in (0.0, 1e9):
            assert clocks[1].deadline(floor) == clocks[0].deadline(floor)


# ---------------------------------------------------------------------------
# poisoned sources, cancellation, deadlines
# ---------------------------------------------------------------------------

def test_poisoned_source_rejected_at_admission(gk):
    def queries(pkg):
        return [pkg.GraphQuery("bfs", 0), pkg.GraphQuery("sssp", 3)]

    (_, _), (te, tq) = _engines(
        gk, queries, plan=dict(poison_source=(1,), poison_value=-7),
        query_slots=2)
    assert tq[1].status == "rejected" and "-7" in tq[1].error
    _assert_solo(te, tq[:1])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_mid_flight_cancellation_spares_cotenants(gk, fused):
    (_, _), (te, tq) = _engines(gk, _mixed, plan=dict(cancel_at=((0, 2),)),
                                query_slots=4, fused=fused)
    assert [q.qid for q in tq if q.status == "cancelled"] == [0]
    assert "tick 2" in tq[0].error


def test_tick_budget_cancels_pathological_query(gk):
    def queries(pkg):
        return [pkg.GraphQuery("ppr", 0, iters=500, tick_budget=4),
                pkg.GraphQuery("bfs", 3)]

    (_, _), (te, tq) = _engines(gk, queries, query_slots=2)
    assert tq[0].status == "cancelled" and "tick budget 4" in tq[0].error
    _assert_solo(te, tq[1:])


def test_straggler_deadline_cancels_stalling_query(gk):
    def queries(pkg):
        return [pkg.GraphQuery("ppr", 0, iters=500), pkg.GraphQuery("bfs", 3),
                pkg.GraphQuery("bfs", 9)]

    (_, _), (te, tq) = _engines(
        gk, queries, plan=dict(hang_at=tuple((0, t) for t in range(2, 40)),
                               hang_seconds=0.05),
        query_slots=3, straggler_factor=1.5, straggler_min_s=0.0)
    assert tq[0].status == "cancelled" and "straggler deadline" in tq[0].error
    _assert_solo(te, tq[1:])


# ---------------------------------------------------------------------------
# fault-plan validation, loud completion timeout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", [dict(overflow_at=(-1,)),
                                  dict(poison_source=(-2,)),
                                  dict(cancel_at=((0, -2),)),
                                  dict(hang_at=((-1, 0),)),
                                  dict(hang_seconds=-0.1)])
def test_query_fault_plan_validates_as_reference(plan):
    with pytest.raises(ValueError) as want:
        jft.QueryFaultPlan(**plan)
    with pytest.raises(ValueError) as got:
        tft.QueryFaultPlan(**plan)
    assert str(got.value) == str(want.value)


def test_query_fault_injector_fires_each_entry_once():
    plan = dict(overflow_at=(2,), cancel_at=((1, 3),), poison_source=(4,),
                hang_at=((0, 1),), hang_seconds=0.0)
    injectors = [ft.QueryFaultInjector(ft.QueryFaultPlan(**plan))
                 for ft in (jft, tft)]
    calls = [("force_overflow", 2), ("force_overflow", 2),
             ("should_cancel", 1, 2), ("should_cancel", 1, 3),
             ("should_cancel", 1, 3), ("admitted_source", 4, 9),
             ("admitted_source", 4, 9), ("stall", 0, 1)]
    for name, *args in calls:
        want, got = (getattr(i, name)(*args) for i in injectors)
        assert got == want, (name, args)
    assert injectors[1].fired == injectors[0].fired


def test_run_to_completion_raises_naming_stuck_queries(gk):
    msgs = []
    for pkg, g, kw in ((jserve, gk[0], {}), (tserve, gk[1], {"device": "cpu"})):
        eng = pkg.GraphServingEngine(g, pkg.GraphServeConfig(
            query_slots=2, capacity_policy=(
                JPolicy if pkg is jserve else TPolicy)(**SMALL)), **kw)
        eng.submit(pkg.GraphQuery("ppr", 0, iters=100))
        eng.submit(pkg.GraphQuery("ppr", 1, iters=100))
        with pytest.raises(TimeoutError, match=r"qids=\[0, 1\]") as e:
            eng.run_to_completion(max_ticks=3)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]

"""Port parity: partitioned multi-tenant serving, the engine on
``partition_csr(tile_csr(g, Q), P)`` (``serve.graph_engine``'s
``_PartitionedFusedRuntime``).

The port's engine on a partitioned view is held against the port's
single-device engine on the same queries (which
``tests/test_torch_serving.py`` holds against the reference engine): BFS
labels and SSSP distances bit for bit, PPR within rtol 1e-5 (+ atol 1e-7
near zero), since the shards sum each rank's contributions in another
order.  With Q = 3 tenants, P = 2 cuts a tenant in two, so the tagged
boundary exchange runs.  At P = 1 the reference's engine serves its own
partitioned view (PPR allclose: the reference's fused PPR is itself not
bit-identical to its solo runs, ROADMAP section C).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core.pipeline import CapacityPolicy as JPolicy
from repro.graphs import csr as jcsr
from repro.graphs.generators import kron as jkron
from repro_torch import serve as tserve
from repro_torch.convert import partition_from_numpy
from repro_torch.core.pipeline import CapacityPolicy as TPolicy
from repro_torch.graphs import csr as tcsr
from torch_parity import jax_graph_to_torch

SMALL = dict(n_buckets=2, min_capacity=256, growth=16)
Q = 3


@pytest.fixture(scope="module")
def gk():
    g = jkron(scale=7, edge_factor=8, seed=4)
    return g, jax_graph_to_torch(g)


def _mixed(pkg):
    G = pkg.GraphQuery
    return [G("bfs", 0), G("sssp", 3), G("ppr", 9, iters=8), G("bfs", 17),
            G("ppr", 0, iters=5), G("sssp", 9)]


def _serve(pkg, graph, policy_cls, **kw):
    device = kw.pop("device", None)
    eng = pkg.GraphServingEngine(graph, pkg.GraphServeConfig(
        query_slots=Q, capacity_policy=policy_cls(**SMALL), **kw),
        **({} if device is None else {"device": device}))
    qs = _mixed(pkg)
    for q in qs:
        eng.submit(q)
    eng.run_to_completion(2000)
    return eng, qs


def _assert_same(want, got, *, ppr_exact=False):
    (we, wq), (ge, gq) = want, got
    assert (ge.overflow_events, ge.quarantines, ge.admission_blocked) == (
        we.overflow_events, we.quarantines, we.admission_blocked)
    for a, b in zip(wq, gq):
        assert (a.status, b.status) == ("done", "done"), (a.error, b.error)
        assert b.result.dtype == a.result.dtype
        if a.kind == "ppr" and not ppr_exact:
            np.testing.assert_allclose(b.result, a.result, rtol=1e-5,
                                       atol=1e-7)
        else:
            assert np.array_equal(b.result, a.result), (a.kind, a.source)


@pytest.mark.parametrize("mode", ["baseline", "sort", "hash"])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_partitioned_engine_matches_single_device(gk, n_parts, mode):
    tg = gk[1]
    want = _serve(tserve, tg, TPolicy, mode=mode, device="cpu")
    pview = tcsr.partition_csr(tcsr.tile_csr(tg, Q), n_parts)
    assert (pview.part.lane_cap > 0) == (n_parts > 1)
    got = _serve(tserve, pview, TPolicy, mode=mode, device="cpu")
    assert got[0].tick_no == want[0].tick_no
    _assert_same(want, got)
    # min-family queries also equal their solo pipeline runs
    for q in got[1]:
        if q.kind != "ppr":
            assert np.array_equal(q.result, got[0].solo_reference(q))


def test_one_shard_matches_reference_engine(gk):
    """The reference engine on its own ``partition_csr(tile_csr(g, Q), 1)``
    (one JAX device) and the port's on the same partition, carried across
    by ``partition_from_numpy``."""
    jview = jcsr.partition_csr(jcsr.tile_csr(gk[0], Q), 1)
    want = _serve(jserve, jview, JPolicy)
    got = _serve(tserve, partition_from_numpy(jview, "cpu"), TPolicy,
                 device="cpu")
    assert got[0].tick_no == want[0].tick_no
    _assert_same(want, got)


def test_overflowed_step_leaves_the_engine_state_intact(gk):
    """A partitioned step that overflows its rung is rerun at the next one
    from the engine's untouched global state; at the top it hands that
    state back (``raise_on_overflow=False``) or raises."""
    pview = tcsr.partition_csr(tcsr.tile_csr(gk[1], Q), 2)
    eng = tserve.GraphServingEngine(pview, tserve.GraphServeConfig(
        query_slots=Q, capacity_policy=TPolicy(**SMALL)), device="cpu")
    for q in _mixed(tserve)[:Q]:
        eng.submit(q)
    eng.tick()  # admit, one step
    pipe = eng._fused_pipe()
    state, mask = eng._fstate, eng._fmask
    before = {k: v.clone() for k, v in state.items()}, mask.clone()
    full = pipe.step(state, mask)
    top = pipe.buckets[-1]
    pipe.buckets = ((8, 8), top)  # rung 0 overflows: retried at the top
    retried = pipe.step(state, mask)
    assert (retried.bucket, retried.overflow) == (1, False)
    for k in full.state:
        assert torch.equal(retried.state[k], full.state[k]), k
    assert torch.equal(retried.mask, full.mask)
    pipe.buckets = ((8, 8),)
    res = pipe.step(state, mask, raise_on_overflow=False)
    assert res.overflow and res.state is state and res.mask is mask
    with pytest.raises(RuntimeError, match="overflowed the top bucket"):
        pipe.step(state, mask)
    for k, v in before[0].items():
        assert torch.equal(state[k], v), k
    assert torch.equal(mask, before[1])

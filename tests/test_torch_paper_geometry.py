"""Port parity under the paper's geometries with a round cap: the 4 x 2
round-cap geometry of the reference's examples (``IRUConfig(num_sets=1024,
slots=32, n_partitions=4, n_banks=2, round_cap=64)``, no window) through
the frontier pipeline, and graph serving (always tagged) under a scaled-down
``IRU_HASH`` (windows, partitions and a round cap), against
``repro.core.pipeline`` and ``repro.serve.graph_engine``.

On the CPU the port runs its plain versions (``batched.py``, ``banked.py``
and the window loop), the code a card run holds kernel B3 against.  Each
test records the port's reorder streams (host numpy, from the calls into
``ops.hash_reorder``) and asserts the branches it is built to trip: on
kron a reorder past the round cap (``ref.max_round_bound`` of a live
stream, or of a window's, above the cap), and in the served mix a window
past the cap and a window past a partition's capacity (the bank bypass).
BFS labels and SSSP distances are bit-identical to the reference's,
PageRank and PPR within rtol 1e-5 (+ atol 1e-9 / 1e-7 near zero: the
port sums in another order).  The reference runs once a module, and its
compiled programs are dropped after it.
"""
from __future__ import annotations

import importlib

import jax
import numpy as np
import pytest

from repro import serve as jserve
from repro.core import iru as jiru
from repro.core import pipeline as jpipe
from repro.core.pipeline import CapacityPolicy as JPolicy
from repro.graphs.generators import make_dataset
from repro_torch import serve as tserve
from repro_torch.core import iru as tiru
from repro_torch.core import pipeline as tpipe
from repro_torch.core.pipeline import CapacityPolicy as TPolicy
from repro_torch.graphs.generators import kron as tkron
from repro_torch.kernels.iru_reorder import ops as hash_ops
from repro_torch.kernels.iru_reorder import ref as hash_ref
from repro.graphs.generators import kron as jkron
from torch_parity import jax_graph_to_torch, n

# examples/quickstart.py and examples/graph_analytics.py: "the paper's 4x2
# banked geometry; the same config drives every app"
ROUND_CAP_4X2 = dict(num_sets=1024, slots=32, n_partitions=4, n_banks=2,
                     round_cap=64)
# IRU_HASH (1024 x 32 sets, 4 x 2 banks, 8192-lane windows, round cap 64)
# scaled to kron-9's serving ticks: 1024-lane windows over 32 x 8 sets, so
# some windows' hub sets pass the cap (8 of the mix's 83 windows) and many
# windows' busiest partition its capacity (56)
SERVING_GEO = dict(num_sets=32, slots=8, n_partitions=4, n_banks=2,
                   round_cap=16, window_elems=1024)
APPS = ("bfs", "sssp", "pagerank")
# the quickstart's delaunay; its kron (scale 11, 25,608 edges) never passes
# the cap (its busiest set takes 26 rounds), so kron at scale 12 with edge
# factor 16, whose PageRank stream's busiest set takes 104
GRAPHS = {"kron12": lambda: jkron(scale=12, edge_factor=16),
          "delaunay48": lambda: make_dataset("delaunay", scale=48)}


def _apps(app):
    jmod, tmod = (importlib.import_module(f"{pkg}.apps.{app}")
                  for pkg in ("repro", "repro_torch"))
    if app == "pagerank":
        return jmod.pagerank_app(8), tmod.pagerank_app(8), 8
    name = f"{app.upper()}_APP"
    return getattr(jmod, name), getattr(tmod, name), None


class _Recorder:
    """The port's reorder streams: each outermost call of
    ``ops.hash_reorder`` as (live indices, its keywords); the plain window
    loop's calls of one window each are inside one."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.depth = 0
        inner = hash_ops.hash_reorder

        def spy(indices, secondary=None, **kw):
            if self.depth == 0:
                live = kw.get("n_live")
                idx = n(indices)
                if live is not None:
                    idx = idx[:int(live)]
                self.calls.append((idx, kw))
            self.depth += 1
            try:
                return inner(indices, secondary, **kw)
            finally:
                self.depth -= 1

        monkeypatch.setattr(hash_ops, "hash_reorder", spy)

    def windows(self):
        """Every reorder's windows (the whole live stream without one), as
        (indices, kw)."""
        for idx, kw in self.calls:
            w = kw.get("window_elems") or max(idx.size, 1)
            for s0 in range(0, idx.size, w):
                yield idx[s0:s0 + w], kw

    def capped(self) -> int:
        """Windows past the round cap: ref.max_round_bound above it."""
        return sum(hash_ref.max_round_bound(
            x, num_sets=kw["num_sets"], slots=kw["slots"]) > kw["round_cap"]
            for x, kw in self.windows() if x.size)

    def bypassed(self) -> int:
        """Windows whose busiest partition passes its capacity."""
        out = 0
        for x, kw in self.windows():
            parts = kw["n_partitions"]
            if parts > 1 and x.size:
                cnt = np.bincount(hash_ref.hash_set(
                    x // np.int32(32), kw["num_sets"]) % parts,
                    minlength=parts)
                out += cnt.max() > hash_ref.partition_capacity(x.size, parts)
        return out


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph(request):
    jg = GRAPHS[request.param]()
    return request.param, jg, jax_graph_to_torch(jg)


@pytest.fixture(scope="module")
def reference_runs(graph):
    """The reference's run of each app under the 4 x 2 round-cap geometry,
    from the graph's highest-degree node (the quickstart's source)."""
    gname, jg, _ = graph
    source = int(np.argmax(np.asarray(jg.degrees())))
    cfg = jiru.IRUConfig(mode="hash", **ROUND_CAP_4X2)
    runs = {}
    for app in APPS:
        japp, _, iters = _apps(app)
        jp = jpipe.FrontierPipeline(jg, japp, mode="hash", max_iters=iters,
                                    gather="xla", iru_config=cfg)
        runs[app] = np.asarray(jp.run(source)), jp.n_hops
    # the compiled pipelines go: a worker that runs many more JAX compiles
    # after this module can run out of JIT code memory
    jax.clear_caches()
    return source, runs


@pytest.mark.parametrize("app", APPS)
def test_round_cap_geometry_pipeline_matches_reference(graph, reference_runs,
                                                       app, monkeypatch):
    gname, _, tg = graph
    source, runs = reference_runs
    _, tapp, iters = _apps(app)
    rec = _Recorder(monkeypatch)
    tp = tpipe.FrontierPipeline(
        tg, tapp, mode="hash", max_iters=iters, device="cpu",
        iru_config=tiru.IRUConfig(mode="hash", **ROUND_CAP_4X2))
    got = n(tp.run(source))
    want, hops = runs[app]
    assert got.dtype == want.dtype
    if app == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    else:
        assert np.array_equal(got, want)
    assert tp.n_hops == hops
    assert rec.calls and all(kw["round_cap"] == 64 and kw["n_partitions"] == 4
                             for _, kw in rec.calls)
    if gname.startswith("kron"):  # its hub sets pass the cap: the fallback
        assert rec.capped() > 0


def _mixed(pkg, sources=(0, 3, 9, 17)):
    Q, s = pkg.GraphQuery, list(sources)
    return [Q("bfs", s[0]), Q("sssp", s[1]), Q("ppr", s[2], iters=8),
            Q("bfs", s[3]), Q("ppr", s[0], iters=5), Q("sssp", s[2])]


SERVING_POLICY = dict(n_buckets=2, min_capacity=256, growth=16)


@pytest.fixture(scope="module")
def served_reference():
    """The reference engine's run of the mix under SERVING_GEO (fused hash,
    tagged), and its graph."""
    jg = jkron(scale=9, edge_factor=8, seed=4)
    eng = jserve.GraphServingEngine(jg, jserve.GraphServeConfig(
        capacity_policy=JPolicy(**SERVING_POLICY), mode="hash", fused=True,
        iru_config=jiru.IRUConfig(mode="hash", **SERVING_GEO)))
    qs = _mixed(jserve)
    for q in qs:
        eng.submit(q)
    eng.run_to_completion(2000)
    jax.clear_caches()
    return eng, qs


def test_serving_under_scaled_iru_hash_matches_reference(served_reference,
                                                         monkeypatch):
    je, jq = served_reference
    rec = _Recorder(monkeypatch)
    te = tserve.GraphServingEngine(
        tkron(scale=9, edge_factor=8, seed=4, device="cpu"),
        tserve.GraphServeConfig(
            capacity_policy=TPolicy(**SERVING_POLICY), mode="hash",
            fused=True, iru_config=tiru.IRUConfig(mode="hash",
                                                  **SERVING_GEO)),
        device="cpu")
    tq = _mixed(tserve)
    for q in tq:
        te.submit(q)
    te.run_to_completion(2000)
    assert te.tick_no == je.tick_no
    assert (te.overflow_events, te.quarantines) == (je.overflow_events,
                                                    je.quarantines)
    for a, b in zip(jq, tq):
        assert (b.status, b.retries) == (a.status, a.retries) == ("done", 0)
        assert b.result.dtype == a.result.dtype
        if a.kind == "ppr":
            np.testing.assert_allclose(b.result, a.result, rtol=1e-5,
                                       atol=1e-7)
        else:
            assert np.array_equal(b.result, a.result), (a.kind, a.source)
    # every reorder tagged, under the served geometry; both branches trip
    assert rec.calls and all(kw["filter_op"] == "tagged"
                             and kw["window_elems"] == 1024
                             for _, kw in rec.calls)
    assert rec.capped() > 0
    assert rec.bypassed() > 0

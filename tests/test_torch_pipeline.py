"""Port parity: the whole slice (``FrontierPipeline`` with BFS, SSSP and
PageRank, baseline / sort / hash) against ``repro.core.pipeline`` with
``gather="xla"``.

BFS labels and SSSP distances are bit-identical (min merges are order free,
and SSSP's per-edge sums are the same f32 adds).  PageRank is held to rtol
1e-5 (+ atol 1e-9 for ranks near zero): its contributions are summed in
another order.  The bucket hops (``n_hops``) must match too: the port's host
loop re-implements the reference's per-rung ``while_loop`` rule.  Every
graph crosses to the port through ``repro_torch.convert``.
"""
from __future__ import annotations

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.graphs import csr as jcsr
from repro_torch.convert import state_from_numpy
from repro_torch.core import pipeline as tpipe
from repro_torch.graphs import generators
from torch_parity import jax_graph_to_torch, n, t

# the app modules (``repro.apps`` re-exports functions under the same names)
jbfs, jsssp, jpr, tbfs, tsssp, tpr = (
    importlib.import_module(f"{pkg}.apps.{app}")
    for pkg in ("repro", "repro_torch") for app in ("bfs", "sssp", "pagerank"))


def _weighted(edges, seed):
    src, dst, nn = edges
    w = np.random.default_rng(seed).uniform(1.0, 64.0, src.shape[0]).astype(
        np.float32)
    return jcsr.from_edges(src, dst, nn, w, symmetrize=True)


GRAPHS = {
    "kron8": lambda: _weighted(generators.kron_edges(scale=8), 1),
    "delaunay16": lambda: _weighted(generators.delaunay_edges(scale=16), 2),
}
POLICIES = {
    1: (jpipe.CapacityPolicy(), tpipe.CapacityPolicy()),
    3: (jpipe.CapacityPolicy(n_buckets=3, min_capacity=64, growth=4),
        tpipe.CapacityPolicy(n_buckets=3, min_capacity=64, growth=4)),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graphs(request):
    jg = GRAPHS[request.param]()
    return jg, jax_graph_to_torch(jg)


def _apps(name):
    if name == "bfs":
        return jbfs.BFS_APP, tbfs.BFS_APP, None
    if name == "sssp":
        return jsssp.SSSP_APP, tsssp.SSSP_APP, None
    return jpr.pagerank_app(iters=12), tpr.pagerank_app(iters=12), 12


@pytest.mark.parametrize("app", ["bfs", "sssp", "pagerank"])
@pytest.mark.parametrize("mode", ["baseline", "sort", "hash"])
@pytest.mark.parametrize("buckets", [1, 3])
def test_pipeline_matches_reference(graphs, app, mode, buckets):
    jg, tg = graphs
    japp, tapp, iters = _apps(app)
    jpol, tpol = POLICIES[buckets]
    jp = jpipe.FrontierPipeline(jg, japp, mode=mode, capacity_policy=jpol,
                                max_iters=iters, gather="xla")
    tp = tpipe.FrontierPipeline(tg, tapp, mode=mode, capacity_policy=tpol,
                                max_iters=iters, device="cpu")
    want, got = np.asarray(jp.run(3)), n(tp.run(3))
    assert want.dtype == got.dtype
    if app == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    else:
        assert np.array_equal(got, want)
    assert tp.n_hops == jp.n_hops


@pytest.mark.parametrize("kernels", [pytest.param(True, id="kernel"),
                                     pytest.param(False, id="torch")])
def test_wrappers_and_oracles_match_reference(graphs, kernels):
    jg, tg = graphs
    kw = dict(mode="sort", device="cpu", kernels=kernels,
              capacity_policy=POLICIES[3][1])
    want_bfs = jbfs.bfs(jg, 5)
    assert np.array_equal(tbfs.bfs(tg, 5), want_bfs)
    assert np.array_equal(n(tbfs.bfs_pipeline(tg, 5, **kw)), want_bfs)
    want_sssp = jsssp.sssp(jg, 5)
    assert np.array_equal(tsssp.sssp(tg, 5), want_sssp)
    assert np.array_equal(n(tsssp.sssp_pipeline(tg, 5, **kw)), want_sssp)
    want_pr = jpr.pagerank(jg, iters=10)
    assert np.array_equal(tpr.pagerank(tg, iters=10), want_pr)
    np.testing.assert_allclose(n(tpr.pagerank_pipeline(tg, iters=10, **kw)),
                               want_pr, rtol=1e-5, atol=1e-9)


def test_step_from_converted_state_matches_reference(graphs):
    """Carry a mid-traversal reference state across and step both."""
    jg, tg = graphs
    pol_j = jpipe.CapacityPolicy(n_buckets=3, min_capacity=64, growth=4)
    jp = jpipe.FrontierPipeline(jg, jsssp.SSSP_APP, mode="sort",
                                capacity_policy=pol_j)
    tp = tpipe.FrontierPipeline(tg, tsssp.SSSP_APP, mode="sort",
                                capacity_policy=POLICIES[3][1], device="cpu")
    state, mask = jp.init(0)
    for _ in range(2):
        r = jp.step(state, mask)
        state, mask = r.state, r.mask
    want = jp.step(state, mask)
    got = tp.step(state_from_numpy(state, "cpu"), t(np.asarray(mask)))
    assert got.bucket == want.bucket and got.overflow == want.overflow
    assert np.array_equal(n(got.state["dist"]), np.asarray(want.state["dist"]))
    for field in ("mask", "idx", "act", "real", "n_edges"):
        assert np.array_equal(n(getattr(got, field)),
                              np.asarray(getattr(want, field))), field


def test_frontier_step_direct_matches_reference(graphs):
    jg, tg = graphs
    state, mask = jbfs.BFS_APP.init(jg, 1)
    jout = jpipe.frontier_step(jg, jbfs.BFS_APP, state, mask, e_cap=jg.n_edges,
                               f_cap=jg.n_nodes, iru_config=None)
    tout = tpipe.frontier_step(tg, tbfs.BFS_APP, state_from_numpy(state, "cpu"),
                               t(np.asarray(mask)), e_cap=tg.n_edges,
                               f_cap=tg.n_nodes, iru_config=None)
    assert np.array_equal(n(tout[0]["label"]), np.asarray(jout[0]["label"]))
    for a, b in zip(jout[1:], tout[1:]):
        assert np.array_equal(np.asarray(a), n(b))


def test_shrunk_capacity_overflow(graphs):
    jg, tg = graphs
    hub = int(tg.degrees().argmax())  # degree >= 2 overflows one lane
    tp = tpipe.FrontierPipeline(tg, tbfs.BFS_APP, mode="sort",
                                edge_capacity=1, device="cpu")
    with pytest.raises(RuntimeError, match="edge_capacity"):
        tp.run(hub)
    state, mask = tp.init(hub)
    r = tp.step(state, mask, raise_on_overflow=False)
    assert r.overflow and r.state is state and r.mask is mask
    with pytest.raises(RuntimeError, match="top bucket"):
        tp.step(state, mask)


def test_capacity_ladder_matches_reference():
    for kw in (dict(), dict(n_buckets=3, min_capacity=64, growth=4),
               dict(n_buckets=5, min_capacity=10, growth=2)):
        for cap, nodes in ((5000, 300), (64, 10), (1, 1)):
            assert (tpipe.CapacityPolicy(**kw).ladder(cap, nodes)
                    == jpipe.CapacityPolicy(**kw).ladder(cap, nodes))
    for bad in (dict(n_buckets=0), dict(min_capacity=0), dict(growth=1),
                dict(hysteresis=0.5)):
        with pytest.raises(ValueError):
            tpipe.CapacityPolicy(**bad)


def test_pipeline_rejects_hash_mode_and_unknown_options(graphs):
    _, tg = graphs
    with pytest.raises(ValueError, match="hash_ref"):  # the host oracle
        tpipe.FrontierPipeline(tg, tbfs.BFS_APP, mode="hash_ref",
                               device="cpu")
    with pytest.raises(ValueError):
        tpipe.FrontierPipeline(tg, tbfs.BFS_APP, mode="bogus", device="cpu")
    with pytest.raises(TypeError):  # one kernels switch, no per-stage names
        tpipe.FrontierPipeline(tg, tbfs.BFS_APP, gather="xla", device="cpu")


def test_scatter_drop_matches_reference():
    rng = np.random.default_rng(0)
    target = rng.uniform(0, 5, 30).astype(np.float32)
    idx = rng.integers(0, 31, 90).astype(np.int32)  # 30 = sentinel lanes
    val = rng.uniform(0, 5, 90).astype(np.float32)
    act = rng.random(90) < 0.7
    for op in ("add", "min", "max"):
        want = jpipe._scatter(jnp.asarray(target), jnp.asarray(idx),
                              jnp.asarray(val), jnp.asarray(act), op)
        got = tpipe._scatter(t(target), t(idx), t(val), t(act), op)
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6)
    with pytest.raises(ValueError):
        tpipe._scatter(t(target), t(idx), t(val), t(act), "mul")
    assert torch.equal(tpipe._scatter(t(target), t(idx), t(val),
                                      t(np.zeros(90, bool)), "min"),
                       t(target))


@pytest.mark.parametrize("app", ["bfs", "sssp", "pagerank"])
def test_pipeline_matches_reference_kron10(app):
    jg = _weighted(generators.kron_edges(scale=10), 3)
    japp, tapp, iters = _apps(app)
    jpol, tpol = POLICIES[3]
    jp = jpipe.FrontierPipeline(jg, japp, mode="sort", capacity_policy=jpol,
                                max_iters=iters)
    tp = tpipe.FrontierPipeline(jax_graph_to_torch(jg), tapp, mode="sort",
                                capacity_policy=tpol, max_iters=iters,
                                device="cpu")
    want, got = np.asarray(jp.run(0)), n(tp.run(0))
    if app == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    else:
        assert np.array_equal(got, want)
    assert tp.n_hops == jp.n_hops


@pytest.mark.parametrize("app", ["bfs", "pagerank"])
def test_padded_execution_matches_reference(graphs, app):
    """``ragged=False``: the sort engine sees the whole padded bucket."""
    jg, tg = graphs
    japp, tapp, iters = _apps(app)
    jpol, tpol = POLICIES[3]
    jp = jpipe.FrontierPipeline(jg, japp, mode="sort", capacity_policy=jpol,
                                max_iters=iters, ragged=False)
    tp = tpipe.FrontierPipeline(tg, tapp, mode="sort", capacity_policy=tpol,
                                max_iters=iters, ragged=False, device="cpu")
    want, got = np.asarray(jp.run(2)), n(tp.run(2))
    if app == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("app", ["bfs", "sssp", "pagerank"])
def test_padded_hash_matches_reference(graphs, app):
    """``ragged=False``: the hash engine sees the padded bucket, whose
    sentinel lanes hash and merge as ordinary elements."""
    jg, tg = graphs
    japp, tapp, iters = _apps(app)
    jpol, tpol = POLICIES[3]
    jp = jpipe.FrontierPipeline(jg, japp, mode="hash", capacity_policy=jpol,
                                max_iters=iters, ragged=False)
    tp = tpipe.FrontierPipeline(tg, tapp, mode="hash", capacity_policy=tpol,
                                max_iters=iters, ragged=False, device="cpu")
    want, got = np.asarray(jp.run(2)), n(tp.run(2))
    if app == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    else:
        assert np.array_equal(got, want)
    assert tp.n_hops == jp.n_hops


@pytest.mark.parametrize("app", ["bfs", "sssp", "pagerank"])
def test_hash_wrappers_match_oracles(graphs, app):
    """The ``*_pipeline`` wrappers let ``mode="hash"`` through, on either
    path, and land on the host oracles."""
    _, tg = graphs
    kw = dict(mode="hash", device="cpu", capacity_policy=POLICIES[3][1])
    for kernels in (True, False):
        if app == "bfs":
            got, want = tbfs.bfs_pipeline(tg, 4, kernels=kernels, **kw), \
                tbfs.bfs(tg, 4)
        elif app == "sssp":
            got, want = tsssp.sssp_pipeline(tg, 4, kernels=kernels, **kw), \
                tsssp.sssp(tg, 4)
        else:
            got = tpr.pagerank_pipeline(tg, iters=6, kernels=kernels, **kw)
            np.testing.assert_allclose(n(got), tpr.pagerank(tg, iters=6),
                                       rtol=1e-5, atol=1e-9)
            continue
        assert np.array_equal(n(got), want)


# ---------------------------------------------------------------------------
# the tagged (fused min+add) datapath and PPR
# ---------------------------------------------------------------------------

def test_scatter_add_accumulates_in_float64():
    """A float64 target (the PPR apps' accumulator) sums f32 lanes in
    float64, so on these lanes the f32-rounded sum does not depend on the
    order the card's atomics add in; an f32 target stays f32."""
    rng = np.random.default_rng(8)
    val = rng.uniform(0, 1, 50_000).astype(np.float32)
    idx = np.zeros(50_000, np.int32)
    act = np.ones(50_000, bool)
    want = np.float32(val.astype(np.float64).sum() + 0.5)
    for perm in (np.arange(50_000), rng.permutation(50_000)):
        got = n(tpipe._scatter(t(np.array([0.5], np.float64)), t(idx),
                               t(val[perm]), t(act), "add"))
        assert got.dtype == np.float64 and np.float32(got[0]) == want
    got = n(tpipe._scatter(t(np.array([0.5], np.float32)), t(idx), t(val),
                           t(act), "add"))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got[0], want, rtol=1e-5)


@pytest.mark.parametrize("mode", ["baseline", "hash"])
def test_pagerank_ranks_do_not_depend_on_lane_order(monkeypatch, mode):
    """The pipeline's PageRank sums each node's contributions in float64
    and rounds to f32 once, so its ranks are bit-equal when every step's
    lanes reach the scatter in another order (the card's atomics add in a
    new order every run); with an f32 accumulator the unmerged (baseline)
    stream's are not."""
    tg = jax_graph_to_torch(_weighted(generators.kron_edges(scale=9), 4))
    scatter = tpipe._scatter
    rng = np.random.default_rng(9)

    def permuted(target, idx, val, act, op, tags=None):
        p = torch.from_numpy(rng.permutation(idx.shape[0]))
        return scatter(target, idx[p], val[p], act[p], op,
                       None if tags is None else tags[p])

    def f32_app(iters):
        app = tpr.pagerank_app(iters)

        def init(graph, source):
            state, mask = app.init(graph, source)
            return {**state, "acc": state["acc"].float()}, mask

        return dataclasses.replace(app, init=init)

    def ranks(app, shuffle):
        if shuffle:
            monkeypatch.setattr(tpipe, "_scatter", permuted)
        pipe = tpipe.FrontierPipeline(tg, app, mode=mode, max_iters=8,
                                      device="cpu")
        out = n(pipe.run())
        monkeypatch.setattr(tpipe, "_scatter", scatter)
        return out

    want = ranks(tpr.pagerank_app(8), False)
    assert want.dtype == np.float32
    for _ in range(2):
        assert np.array_equal(ranks(tpr.pagerank_app(8), True), want)
    f32 = ranks(f32_app(8), False)
    np.testing.assert_allclose(f32, want, rtol=1e-5)
    assert mode == "hash" or not all(np.array_equal(ranks(f32_app(8), True), f32)
                   for _ in range(2))


def test_tagged_scatter_matches_reference():
    """Min lanes exact, add lanes within rtol 1e-5; each family's lanes go
    to their sinks in the other family's pass."""
    rng = np.random.default_rng(5)
    target = rng.uniform(0, 5, 40).astype(np.float32)
    idx = rng.integers(0, 41, 200).astype(np.int32)  # 40 = sentinel lanes
    val = rng.uniform(0, 5, 200).astype(np.float32)
    act = rng.random(200) < 0.7
    family = rng.random(41) < 0.5
    family[40] = False
    tags = family[idx]
    want = np.asarray(jpipe._scatter(jnp.asarray(target), jnp.asarray(idx),
                                     jnp.asarray(val), jnp.asarray(act),
                                     "tagged", tags=jnp.asarray(tags)))
    got = n(tpipe._scatter(t(target), t(idx), t(val), t(act), "tagged",
                           tags=t(tags)))
    assert np.array_equal(got[~family[:40]], want[~family[:40]])
    np.testing.assert_allclose(got[family[:40]], want[family[:40]],
                               rtol=1e-5)
    with pytest.raises(ValueError, match="tags"):
        tpipe._scatter(t(target), t(idx), t(val), t(act), "tagged")


def _fused_state(Q, n_base, sources):
    """A fused serving state: slot 0 BFS, slot 1 PPR, slot 2 SSSP."""
    val = np.full(Q * n_base, np.inf, np.float32)
    tgt = val.copy()
    src = np.zeros(Q * n_base, np.float32)
    mask = np.zeros(Q * n_base, bool)
    lane = slice(n_base, 2 * n_base)
    val[lane], tgt[lane] = 0.0, 0.0
    val[n_base + sources[1]] = src[n_base + sources[1]] = 1.0
    mask[lane] = True
    for slot in (0, 2):
        seed = slot * n_base + sources[slot]
        val[seed] = tgt[seed] = 0.0
        mask[seed] = True
    state = {"val": val, "tgt": tgt, "src": src,
             "tag": np.array([False, True, False]),
             "unit": np.array([True, False, False]),
             "live": np.array([False, True, False]),
             "damp": np.array([0, 0.85, 0], np.float32)}
    return state, mask


@pytest.mark.parametrize("mode", ["baseline", "sort", "hash"])
def test_fused_frontier_step_matches_reference(mode):
    """The serving stack's fused app through ``frontier_step``: two
    reference steps, then the state crosses and both packages step once."""
    from repro.core.iru import IRUConfig as JConfig
    from repro.graphs.csr import tile_csr as jtile
    from repro.serve.graph_engine import _fused_family_app as japp_of
    from repro_torch.core.iru import IRUConfig as TConfig
    from repro_torch.graphs.csr import tile_csr as ttile
    from repro_torch.serve.graph_engine import _fused_family_app as tapp_of

    Q = 3
    jg = _weighted(generators.kron_edges(scale=6), 4)
    jv = jtile(jg, Q)
    tv = ttile(jax_graph_to_torch(jg), Q)
    japp, tapp = japp_of(Q, jg.n_nodes), tapp_of(Q, jg.n_nodes)
    cfgs = (None, None) if mode == "baseline" else (
        JConfig(mode=mode, filter_op="tagged"),
        TConfig(mode=mode, filter_op="tagged"))
    state, mask = _fused_state(Q, jg.n_nodes, (1, 2, 3))
    state = {k: jnp.asarray(v) for k, v in state.items()}
    mask = jnp.asarray(mask)
    caps = dict(e_cap=jv.n_edges, f_cap=jv.n_nodes)
    for _ in range(2):
        state, mask, *_ = jpipe.frontier_step(jv, japp, state, mask,
                                              iru_config=cfgs[0], **caps)
    want = jpipe.frontier_step(jv, japp, state, mask, iru_config=cfgs[0],
                               **caps)
    got = tpipe.frontier_step(tv, tapp, state_from_numpy(state, "cpu"),
                              t(np.asarray(mask)), iru_config=cfgs[1], **caps)
    add = np.repeat(np.asarray(state["tag"]), jg.n_nodes)
    for key in ("val", "tgt"):
        w, g = np.asarray(want[0][key]), n(got[0][key])
        assert np.array_equal(g[~add], w[~add]), key
        np.testing.assert_allclose(g[add], w[add], rtol=1e-5, atol=1e-7)
    for a, b in zip(want[1:], got[1:]):
        assert np.array_equal(n(b), np.asarray(a))
    bad = dataclasses.replace(tapp, tag_table=None)
    with pytest.raises(ValueError, match="tag_table"):
        tpipe.frontier_step(tv, bad, state_from_numpy(state, "cpu"),
                            t(np.asarray(mask)), **caps)


@pytest.mark.parametrize("mode", ["baseline", "sort", "hash"])
def test_ppr_pipeline_matches_reference_and_oracle(graphs, mode):
    jppr, tppr = (importlib.import_module(f"{pkg}.apps.ppr")
                  for pkg in ("repro", "repro_torch"))
    jg, tg = graphs
    kw = dict(iters=7, damping=0.85, mode=mode)
    want = jppr.ppr_pipeline(jg, 3, capacity_policy=POLICIES[3][0], **kw)
    got = n(tppr.ppr_pipeline(tg, 3, capacity_policy=POLICIES[3][1],
                              device="cpu", **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    oracle = jppr.ppr(jg, 3, iters=7)
    assert np.array_equal(tppr.ppr(tg, 3, iters=7), oracle)
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-9)

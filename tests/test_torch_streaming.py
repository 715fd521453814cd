"""Port parity: streaming windows (``IRUConfig.window_elems``), the host
entry point ``reorder_frontier``, ``load_iru_gather`` and the paper's IRU
geometry through the frontier pipeline, against ``repro.core.iru`` and
``repro.core.pipeline``.

The same seeded numpy inputs go through the reference's
``iru_reorder(..., window_elems=w)`` and the port's, in sort, hash (the
plain versions here) and hash_ref mode: ragged tails (``n % w != 0``),
fully dead windows under ``n_live`` and ``n <= w`` included.  Indices,
positions and active flags are bit-identical; payloads are exact for
``min`` and no merge and held to rtol 1e-5 (+ atol 1e-6) for ``add``
(another fp addition order).  The pipeline runs of the paper's geometry
(``IRU_HASH`` of ``benchmarks/common.py``: 1024 x 32 sets over 4
partitions x 2 banks, 8192-lane windows, round cap 64) give BFS and SSSP
bit-identical to the reference's and PageRank within rtol 1e-5 (+ atol
1e-9).
"""
from __future__ import annotations

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import iru as jiru
from repro.core import pipeline as jpipe
from repro.graphs import csr as jcsr
from repro_torch.core import iru as tiru
from repro_torch.core import pipeline as tpipe
from repro_torch.graphs import generators
from torch_parity import jax_graph_to_torch, n, t

IRU_HASH = dict(num_sets=1024, slots=32, window_elems=8192, n_partitions=4,
                n_banks=2, round_cap=64)


def _assert_equal(got, want, op):
    for field in ("indices", "positions", "active", "secondary"):
        a, b = n(getattr(got, field)), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype, field
        if field == "secondary" and op == "add":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        else:
            assert np.array_equal(a, b), field


def _both(idx, sec, op, live=None, **kw):
    """The reference and the port on one stream; returns the port's."""
    want = jiru.iru_reorder(jnp.asarray(idx), jnp.asarray(sec),
                            config=jiru.IRUConfig(filter_op=op, **kw),
                            n_live=None if live is None else jnp.int32(live))
    got = tiru.iru_reorder(t(idx), t(sec),
                           config=tiru.IRUConfig(filter_op=op, **kw),
                           n_live=live)
    _assert_equal(got, want, op)
    return got


@pytest.mark.parametrize("mode", ["sort", "hash", "hash_ref"])
@pytest.mark.parametrize("op", [None, "add", "min"])
@pytest.mark.parametrize("n_lanes,w", [(250, 64), (100, 33), (64, 64)])
def test_windowed_matches_reference(mode, op, n_lanes, w):
    rng = np.random.default_rng(n_lanes * 7 + w)
    idx = rng.integers(0, 300, n_lanes).astype(np.int32)
    sec = rng.random(n_lanes).astype(np.float32)
    got = _both(idx, sec, op, mode=mode, num_sets=32, slots=8,
                window_elems=w)
    pos = n(got.positions)
    assert np.array_equal(np.sort(pos), np.arange(n_lanes))


@pytest.mark.parametrize("mode", ["sort", "hash", "hash_ref"])
@pytest.mark.parametrize("n_lanes,live", [(250, 0), (250, 100), (250, 250),
                                          (60, 41)])
def test_windowed_ragged_matches_reference(mode, n_lanes, live):
    """Each window holds clip(n_live - i*w, 0, w) live lanes; a fully dead
    window is the identity layout; n <= w is one window."""
    rng = np.random.default_rng(n_lanes + live)
    idx = rng.integers(0, 200, n_lanes).astype(np.int32)
    sec = rng.random(n_lanes).astype(np.float32)
    got = _both(idx, sec, "min", live, mode=mode, num_sets=32, slots=8,
                window_elems=64)
    if live < n_lanes - 64:  # the last window is fully dead
        tail = slice(n_lanes - n_lanes % 64 or n_lanes - 64, n_lanes)
        assert np.array_equal(n(got.positions)[tail],
                              np.arange(n_lanes)[tail])
        assert not n(got.active)[tail].any()


@pytest.mark.parametrize("mode", ["hash", "hash_ref"])
@pytest.mark.parametrize("op", ["add", "min"])
def test_banked_windows_match_reference(mode, op):
    """The banked geometry with a round cap, window by window: hot windows
    take the fallback, the rest the hash."""
    rng = np.random.default_rng(31)
    idx = np.concatenate([rng.integers(0, 40, 300),
                          rng.integers(0, 5000, 700)]).astype(np.int32)
    sec = rng.random(1000).astype(np.float32)
    _both(idx, sec, op, 800, mode=mode, num_sets=32, slots=8,
          n_partitions=4, round_cap=4, window_elems=128)


@pytest.mark.parametrize("mode", ["sort", "hash", "hash_ref"])
def test_reorder_frontier_matches_reference(mode):
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 300, 500)                        # int64 on purpose
    vals = rng.random(500)                                 # float64 likewise
    kw = dict(mode=mode, filter_op="add", num_sets=32, slots=8,
              window_elems=128)
    want = jiru.reorder_frontier(idx, vals, config=jiru.IRUConfig(**kw))
    got = tiru.reorder_frontier(idx, vals, config=tiru.IRUConfig(**kw),
                                device="cpu")
    assert all(isinstance(a, np.ndarray) for a in got)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
    assert got[1].dtype == np.float32 and got[2].dtype == np.int32
    for k in (0, 2, 3):
        assert np.array_equal(got[k], want[k])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


def test_reorder_frontier_defaults_to_the_card():
    cfg = tiru.IRUConfig(mode="hash")
    if torch.cuda.is_available():
        pytest.skip("this case checks the refusal without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tiru.reorder_frontier(np.arange(8), config=cfg)
    # hash_ref stays on the host and needs no device
    out = tiru.reorder_frontier(np.arange(8),
                                config=dataclasses.replace(cfg,
                                                           mode="hash_ref"))
    assert np.array_equal(np.sort(out[2]), np.arange(8))


@pytest.mark.parametrize("mode", ["sort", "hash"])
def test_load_iru_gather_matches_reference(mode):
    rng = np.random.default_rng(4)
    table = rng.random((300, 2)).astype(np.float32)
    idx = rng.integers(0, 300, 400).astype(np.int32)
    kw = dict(mode=mode, num_sets=32, slots=8, window_elems=128)
    rows_j, sj = jiru.load_iru_gather(jnp.asarray(table), jnp.asarray(idx),
                                      config=jiru.IRUConfig(**kw))
    rows_t, st = tiru.load_iru_gather(t(table), t(idx),
                                      config=tiru.IRUConfig(**kw))
    assert np.array_equal(n(rows_t), np.asarray(rows_j))
    assert np.array_equal(n(st.positions), np.asarray(sj.positions))
    assert np.array_equal(n(rows_t), table[n(st.indices)])


def _weighted(edges, seed):
    src, dst, nn = edges
    w = np.random.default_rng(seed).uniform(1.0, 64.0, src.shape[0]).astype(
        np.float32)
    return jcsr.from_edges(src, dst, nn, w, symmetrize=True)


GRAPHS = {
    "kron8": lambda: _weighted(generators.kron_edges(scale=8), 1),
    "delaunay16": lambda: _weighted(generators.delaunay_edges(scale=16), 2),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graphs(request):
    jg = GRAPHS[request.param]()
    return jg, jax_graph_to_torch(jg)


@pytest.mark.parametrize("app", ["bfs", "sssp", "pagerank"])
def test_pipeline_with_the_paper_geometry_matches_reference(graphs, app):
    jg, tg = graphs
    jmod, tmod = (importlib.import_module(f"{pkg}.apps.{app}")
                  for pkg in ("repro", "repro_torch"))
    if app == "pagerank":
        japp, tapp, iters = jmod.pagerank_app(12), tmod.pagerank_app(12), 12
    else:
        name = f"{app.upper()}_APP"
        japp, tapp, iters = getattr(jmod, name), getattr(tmod, name), None
    jp = jpipe.FrontierPipeline(
        jg, japp, mode="hash", max_iters=iters, gather="xla",
        iru_config=jiru.IRUConfig(mode="hash", **IRU_HASH))
    tp = tpipe.FrontierPipeline(
        tg, tapp, mode="hash", max_iters=iters, device="cpu",
        iru_config=tiru.IRUConfig(mode="hash", **IRU_HASH))
    assert tp.iru_config.window_elems == 8192
    assert tp.iru_config.n_partitions == 4 and tp.iru_config.round_cap == 64
    want, got = np.asarray(jp.run(3)), n(tp.run(3))
    assert want.dtype == got.dtype
    if app == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    else:
        assert np.array_equal(got, want)
    assert tp.n_hops == jp.n_hops


def test_pipeline_with_short_windows_matches_reference():
    """The paper's geometry with 256-lane windows, so PageRank's stream on
    kron-8 spans many windows."""
    jg = GRAPHS["kron8"]()
    tg = jax_graph_to_torch(jg)
    jpr, tpr = (importlib.import_module(f"{pkg}.apps.pagerank")
                for pkg in ("repro", "repro_torch"))
    geo = dict(IRU_HASH, window_elems=256)
    jp = jpipe.FrontierPipeline(jg, jpr.pagerank_app(6), mode="hash",
                                max_iters=6, gather="xla",
                                iru_config=jiru.IRUConfig(mode="hash", **geo))
    tp = tpipe.FrontierPipeline(tg, tpr.pagerank_app(6), mode="hash",
                                max_iters=6, device="cpu",
                                iru_config=tiru.IRUConfig(mode="hash", **geo))
    np.testing.assert_allclose(n(tp.run(3)), np.asarray(jp.run(3)),
                               rtol=1e-5, atol=1e-9)

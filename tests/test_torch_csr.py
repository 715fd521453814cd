"""Port parity: ``repro_torch.graphs`` against ``repro.graphs`` (expand stage).

Everything here is integer bookkeeping or a copy of a numpy constructor, so the
tolerance is exact equality throughout.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coalescing as jcoal
from repro.graphs import csr as jcsr
from repro.graphs import generators as jgen
from repro_torch.core import coalescing
from repro_torch.graphs import csr, generators
from torch_parity import jax_graph_to_torch, n, t

GRAPHS = {
    "kron8": lambda: jgen.kron(scale=8),
    "kron10": lambda: jgen.kron(scale=10),
    "delaunay16": lambda: jgen.delaunay(scale=16),
}


@pytest.fixture(scope="module", params=["kron8", "delaunay16"])
def graphs(request):
    jg = GRAPHS[request.param]()
    return jg, jax_graph_to_torch(jg)


@pytest.mark.parametrize("name,make", [
    ("kron8", lambda: generators.kron(scale=8, device="cpu")),
    ("kron10", lambda: generators.kron(scale=10, device="cpu")),
    ("delaunay16", lambda: generators.delaunay(scale=16, device="cpu")),
])
def test_generators_bit_identical(name, make):
    jg, tg = GRAPHS[name](), make()
    for field in ("row_ptr", "col_idx", "weights"):
        a, b = np.asarray(getattr(jg, field)), n(getattr(tg, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("symmetrize,dedup", [(True, True), (False, True),
                                              (True, False)])
def test_from_edges_bit_identical(symmetrize, dedup):
    rng = np.random.default_rng(3)
    src = rng.integers(-2, 70, 500)
    dst = rng.integers(0, 72, 500)
    w = rng.uniform(1.0, 64.0, 500).astype(np.float32)
    jg = jcsr.from_edges(src, dst, 64, w, symmetrize=symmetrize, dedup=dedup)
    tg = csr.from_edges(src, dst, 64, w, symmetrize=symmetrize, dedup=dedup,
                        device="cpu")
    for field in ("row_ptr", "col_idx", "weights"):
        assert np.array_equal(np.asarray(getattr(jg, field)),
                              n(getattr(tg, field))), field
    assert np.array_equal(np.asarray(jg.edge_sources()), n(tg.edge_sources()))
    assert np.array_equal(np.asarray(jg.degrees()), n(tg.degrees()))


def _frontier(jg, kind, rng):
    nn = jg.n_nodes
    if kind == "sparse":
        mask = rng.random(nn) < 0.05
    elif kind == "dense":
        mask = rng.random(nn) < 0.7
    elif kind == "single":
        mask = np.zeros(nn, bool)
        mask[rng.integers(nn)] = True
    else:  # empty
        mask = np.zeros(nn, bool)
    return mask


def _assert_frontiers_equal(jef, tef, with_weights):
    for field in ("srcs", "dsts", "eids", "valid", "overflow", "n_valid"):
        a, b = np.asarray(getattr(jef, field)), n(getattr(tef, field))
        assert a.shape == b.shape and np.array_equal(a, b), field
    if with_weights:
        assert np.array_equal(np.asarray(jef.weights), n(tef.weights))
    else:
        assert tef.weights is None


@pytest.mark.parametrize("kind", ["sparse", "dense", "single", "empty"])
@pytest.mark.parametrize("cap", ["full", "tight", "overflow", "zero"])
@pytest.mark.parametrize("gather", ["torch", "kernel"])
def test_expand_frontier_matches_reference(graphs, kind, cap, gather):
    jg, tg = graphs
    rng = np.random.default_rng(11)
    mask = _frontier(jg, kind, rng)
    need = int(np.asarray(jcsr.frontier_degree_sum(jg, jnp.asarray(mask))))
    e_cap = {"full": None, "tight": max(need, 1), "overflow": need // 2,
             "zero": 0}[cap]
    nodes_j = jcsr.frontier_from_mask(jnp.asarray(mask))
    nodes_t = csr.frontier_from_mask(t(mask))
    assert np.array_equal(np.asarray(nodes_j), n(nodes_t))
    with_weights = kind != "single"
    jef = jcsr.expand_frontier(jg, nodes_j, edge_capacity=e_cap,
                               gather="xla", with_weights=with_weights)
    tef = csr.expand_frontier(tg, nodes_t, edge_capacity=e_cap,
                              gather=gather, with_weights=with_weights)
    _assert_frontiers_equal(jef, tef, with_weights)
    if cap == "overflow" and need > 1:
        assert bool(tef.overflow) and int(tef.n_valid) == e_cap


def test_expand_frontier_zero_length_frontier(graphs):
    jg, tg = graphs
    empty_j = jnp.zeros((0,), jnp.int32)
    jef = jcsr.expand_frontier(jg, empty_j, edge_capacity=32,
                               with_weights=True)
    tef = csr.expand_frontier(tg, torch.zeros(0, dtype=torch.int32),
                              edge_capacity=32, with_weights=True)
    _assert_frontiers_equal(jef, tef, True)


def test_expand_frontier_pad_eid_repeats_last_offset(graphs):
    jg, tg = graphs
    nodes = csr.frontier_from_mask(t(np.arange(tg.n_nodes) < 5))
    ef = csr.expand_frontier(tg, nodes, with_weights=False)
    nv = int(ef.n_valid)
    assert 0 < nv < tg.n_edges
    eids = n(ef.eids)
    assert np.all(eids[nv:] == eids[nv - 1])
    assert np.all(np.diff(eids) >= 0)  # monotone: the gather's contract


def test_expand_frontier_rejects_unknown_gather(graphs):
    _, tg = graphs
    with pytest.raises(ValueError, match="unknown gather"):
        csr.expand_frontier(tg, torch.arange(3, dtype=torch.int32),
                            gather="xla")


@pytest.mark.parametrize("size", [None, 1, 7, 300])
def test_frontier_from_mask_sizes(size):
    rng = np.random.default_rng(5)
    mask = rng.random(200) < 0.2
    a = jcsr.frontier_from_mask(jnp.asarray(mask), size=size)
    b = csr.frontier_from_mask(t(mask), size=size)
    assert np.array_equal(np.asarray(a), n(b))


def test_frontier_degree_sum_mask_and_list(graphs):
    jg, tg = graphs
    rng = np.random.default_rng(9)
    mask = rng.random(jg.n_nodes) < 0.3
    assert int(jcsr.frontier_degree_sum(jg, jnp.asarray(mask))) == int(
        csr.frontier_degree_sum(tg, t(mask)))
    # a padded node list with sentinels and stray negative ids
    ids = rng.integers(-3, jg.n_nodes + 3, 40).astype(np.int32)
    a = jcsr.frontier_degree_sum(jg, jnp.asarray(ids))
    b = csr.frontier_degree_sum(tg, t(ids))
    assert int(a) == int(b) and b.dtype == torch.int32


@pytest.mark.parametrize("elem_bytes", [1, 4, 8])
def test_block_ids_match_reference(elem_bytes):
    idx = np.random.default_rng(2).integers(-50, 5000, 300).astype(np.int32)
    a = jcoal.block_ids(jnp.asarray(idx), elem_bytes)
    b = coalescing.block_ids(t(idx), elem_bytes)
    assert np.array_equal(np.asarray(a), n(b))
    assert coalescing.elems_per_block(elem_bytes) == jcoal.elems_per_block(
        elem_bytes)
    with pytest.raises(ValueError):
        coalescing.elems_per_block(3)

"""Compressed Sparse Row graph container and the frontier expansion stage.

Counterpart of ``repro.graphs.csr`` (``CSRGraph``, ``from_edges``,
``EdgeFrontier``, ``frontier_from_mask``, ``frontier_degree_sum``,
``expand_frontier``, and the serving stack's ``GraphView`` / ``tile_csr``).  Arrays are torch tensors on one device: int32 ids and
offsets, float32 weights, as in the reference (x64 off).

:func:`expand_frontier` keeps the reference's fixed output shapes (every
output is ``[edge_capacity]``; padding lanes carry ``valid=False``), so a
step's allocation depends only on its capacity rung, never on the data.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class CSRGraph:
    row_ptr: torch.Tensor   # int32[n_nodes + 1]
    col_idx: torch.Tensor   # int32[n_edges]  (destination node per edge)
    weights: torch.Tensor   # float32[n_edges]

    @property
    def n_nodes(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.col_idx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def to(self, device: str | torch.device) -> "CSRGraph":
        return CSRGraph(self.row_ptr.to(device), self.col_idx.to(device),
                        self.weights.to(device))

    def degrees(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    def edge_sources(self) -> torch.Tensor:
        """int32[n_edges] source node of each edge (expanded row_ptr)."""
        e = torch.arange(self.n_edges, dtype=torch.int32, device=self.device)
        return (torch.searchsorted(self.row_ptr, e, right=True,
                                   out_int32=True) - 1)


class EdgeFrontier(NamedTuple):
    """Capacity-padded edge frontier (all arrays ``[edge_capacity]``)."""

    srcs: torch.Tensor     # int32 source node per lane (n_nodes on padding)
    dsts: torch.Tensor     # int32 destination node per lane (n_nodes on padding)
    eids: torch.Tensor     # int32 CSR edge offset per lane; padding repeats the
    #                        last real offset so the offset stream stays
    #                        monotone (the gather kernel's window contract)
    valid: torch.Tensor    # bool True on real edge lanes
    weights: torch.Tensor | None = None   # f32 edge weight per lane (on request)
    overflow: torch.Tensor | None = None  # bool 0-d: degree sum > capacity,
    #                        edges were dropped and the caller must re-dispatch
    n_valid: torch.Tensor | None = None   # int32 0-d live lane count, clamped
    #                        to the capacity (a trusted prefix bound)


def frontier_from_mask(mask: torch.Tensor, *,
                       size: int | None = None) -> torch.Tensor:
    """Dense frontier mask -> capacity-padded ascending node list.

    Returns int32[size] (default ``n_nodes``); lanes past the frontier carry
    the sentinel ``n_nodes``.  Like ``jnp.nonzero(size=...)`` a mask with
    more than ``size`` set bits is truncated.  Computed without a host sync:
    each set bit's rank is its output lane, and ranks past ``size`` land in
    a sink slot that is sliced off.
    """
    n = mask.shape[0]
    size = n if size is None else size
    rank = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    dest = torch.where(mask & (rank < size), rank, size).long()
    out = torch.full((size + 1,), n, dtype=torch.int32, device=mask.device)
    out.scatter_(0, dest, torch.arange(n, dtype=torch.int32,
                                       device=mask.device))
    return out[:size]


def _frontier_counts(graph: CSRGraph, frontier: torch.Tensor):
    """Per-node (clipped ids, CSR starts, degree counts) of a node list.

    Out-of-range ids (the ``>= n_nodes`` sentinel, or a stray negative id)
    count zero edges.
    """
    n = graph.n_nodes
    f = frontier.to(torch.int32)
    in_range = (f >= 0) & (f < n)
    fc = f.clamp(0, max(n - 1, 0))
    starts = graph.row_ptr[fc]
    counts = torch.where(in_range, graph.row_ptr[fc + 1] - starts, 0)
    return fc, starts, counts


def frontier_degree_sum(graph: CSRGraph,
                        frontier: torch.Tensor) -> torch.Tensor:
    """Exact lane count :func:`expand_frontier` will emit (int32 0-d).

    ``frontier`` is a dense bool[n_nodes] mask or a padded int32 node list.
    """
    if frontier.dtype == torch.bool:
        return torch.where(frontier, graph.degrees(), 0).sum(
            dtype=torch.int32)
    _, _, counts = _frontier_counts(graph, frontier)
    return counts.sum(dtype=torch.int32)


def expand_frontier(
    graph: CSRGraph,
    frontier: torch.Tensor,
    *,
    edge_capacity: int | None = None,
    gather: str = "kernel",
    with_weights: bool = False,
) -> EdgeFrontier:
    """CSR edge-frontier expansion at a fixed capacity (load-balanced search).

    ``frontier`` is int32[F] unique node ids padded with sentinels
    ``>= n_nodes``.  Each valid node contributes its CSR range, node-major in
    frontier order; a ``searchsorted`` over the degree prefix sum finds each
    output lane's owner.  At most ``edge_capacity`` lanes are emitted;
    ``overflow`` reports a frontier whose degree sum did not fit.

    ``gather`` services ``col_idx`` (and ``weights``): ``"kernel"`` goes
    through the block-reuse gather (kernel B1, the counterpart of the
    reference's ``"pallas"``; its wrapper takes the plain index for CPU
    tensors), ``"torch"`` is a plain index (the counterpart of ``"xla"``).
    """
    n = graph.n_nodes
    dev = graph.device
    cap = graph.n_edges if edge_capacity is None else edge_capacity
    f = frontier.to(torch.int32)
    F = f.shape[0]
    fc, starts, counts = _frontier_counts(graph, f)

    if F == 0 or cap == 0:
        # degenerate shapes collapse to an all-padding frontier (cap == 0
        # can still overflow: edges exist but no lane was sized for them)
        return EdgeFrontier(
            srcs=torch.full((cap,), n, dtype=torch.int32, device=dev),
            dsts=torch.full((cap,), n, dtype=torch.int32, device=dev),
            eids=torch.zeros((cap,), dtype=torch.int32, device=dev),
            valid=torch.zeros((cap,), dtype=torch.bool, device=dev),
            weights=(torch.zeros((cap,), dtype=graph.weights.dtype,
                                 device=dev) if with_weights else None),
            overflow=counts.sum(dtype=torch.int32) > cap,
            n_valid=torch.zeros((), dtype=torch.int32, device=dev))

    cum = torch.cumsum(counts, 0, dtype=torch.int32)
    total = cum[F - 1]
    lane = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = lane < total
    k = torch.searchsorted(cum, lane, right=True, out_int32=True).clamp(
        0, F - 1)
    base = cum[k] - counts[k]
    raw = starts[k] + (lane - base)
    # padding repeats the LAST real offset (not 0): the offset stream stays
    # monotone end to end, so a trailing partial group keeps the gather
    # kernel's window contract
    pad_eid = torch.where(valid, raw, 0).max()
    eids = torch.where(valid, raw, pad_eid)
    srcs = torch.where(valid, fc[k], n)
    weights = None
    if gather == "kernel":
        from repro_torch.kernels.coalesced_gather.ops import csr_edge_gather

        if with_weights:
            dsts, weights = csr_edge_gather(graph.col_idx, eids,
                                            graph.weights)
        else:
            dsts = csr_edge_gather(graph.col_idx, eids)
    elif gather == "torch":
        dsts = graph.col_idx[eids]
        if with_weights:
            weights = graph.weights[eids]
    else:
        raise ValueError(f"unknown gather backend {gather!r}")
    dsts = torch.where(valid, dsts, n)
    return EdgeFrontier(srcs, dsts, eids, valid, weights, total > cap,
                        torch.clamp(total, max=cap))


@dataclasses.dataclass
class GraphView(CSRGraph):
    """A composite ``CSRGraph`` carrying its id-space metadata.

    :func:`tile_csr` emits a ``GraphView``: composite node ``c`` decomposes
    as ``(tenant, local) = divmod(c, base_nodes)``, and that travels with the
    arrays.  A view IS a ``CSRGraph``, so the whole pipeline applies
    unchanged.  Tiling a view multiplies ``n_tenants``; the base stays the
    original base graph.
    """

    n_tenants: int = 1
    base_nodes: int = 0
    base_edges: int = 0

    @property
    def base(self) -> CSRGraph:
        """The single-tenant base graph: exact prefix slices (tenant 0's
        composite ids coincide with base ids)."""
        return CSRGraph(row_ptr=self.row_ptr[:self.base_nodes + 1],
                        col_idx=self.col_idx[:self.base_edges],
                        weights=self.weights[:self.base_edges])

    def to(self, device: str | torch.device) -> "GraphView":
        return GraphView(self.row_ptr.to(device), self.col_idx.to(device),
                         self.weights.to(device), n_tenants=self.n_tenants,
                         base_nodes=self.base_nodes,
                         base_edges=self.base_edges)

    def tenant_of(self, composite_ids):
        """Tenant index of each composite node id."""
        return composite_ids // self.base_nodes

    def local_of(self, composite_ids):
        """Base-graph node id of each composite node id."""
        return composite_ids % self.base_nodes


def tile_csr(graph: CSRGraph, copies: int) -> GraphView:
    """``copies`` disjoint replicas of ``graph`` as one composite CSR view.

    Replica ``q``'s node ``v`` becomes composite node ``q * n_nodes + v`` and
    its edges shift likewise, so a multi-query frontier over the replicas is
    one frontier of composite ``(query, node)`` ids, and duplicate merging
    only ever combines lanes within one query.  Tiling a view composes
    (``n_tenants`` multiplies).  Memory is ``copies`` times the base graph.
    """
    if copies < 1:
        raise ValueError(f"copies must be >= 1, got {copies}")
    n, m = graph.n_nodes, graph.n_edges
    # composite ids pack the tenant into the high part of the node id (and
    # edge offsets shift by q*m): check copies*n and copies*m against the id
    # dtype before anything is allocated, since a wraparound would alias
    # tenants onto each other
    info = np.iinfo(str(graph.col_idx.dtype).removeprefix("torch."))
    if copies * max(n, 1) > info.max or copies * max(m, 1) > info.max:
        raise ValueError(
            f"tile_csr: copies={copies} tenants over a base of n={n} nodes"
            f" / {m} edges needs composite ids up to "
            f"{max(copies * max(n, 1), copies * max(m, 1))}, which"
            f" overflows the {info.dtype.name} id space "
            f"(max {info.max}); int32 ids cap copies at "
            f"{info.max // max(n, m, 1)} for this base graph")
    if isinstance(graph, GraphView):
        base_n, base_m = graph.base_nodes, graph.base_edges
        tenants = graph.n_tenants * copies
    else:
        base_n, base_m, tenants = n, m, copies
    q = torch.arange(copies, dtype=torch.int32, device=graph.device)[:, None]
    # composite row_ptr[c*n + v] = c*m + row_ptr[v]; interior replica
    # boundaries coincide, so each replica's row_ptr[1:] after a leading 0
    row_ptr = torch.cat([graph.row_ptr[:1] * 0,
                         (graph.row_ptr[None, 1:] + q * m).reshape(-1)])
    col_idx = (graph.col_idx[None, :] + q * n).reshape(-1)
    return GraphView(row_ptr=row_ptr, col_idx=col_idx,
                     weights=graph.weights.repeat(copies),
                     n_tenants=tenants, base_nodes=base_n, base_edges=base_m)


def from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    n_nodes: int,
    weights: np.ndarray | None = None,
    *,
    dedup: bool = True,
    symmetrize: bool = False,
    device: str | torch.device | None = None,
) -> CSRGraph:
    """Build a CSR graph from an edge list (numpy; same dedup and lexsort as
    the reference, so the arrays are bit-identical)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if weights is None:
        weights = np.ones(src.shape[0], np.float32)
    weights = np.asarray(weights, np.float32)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        weights = np.concatenate([weights, weights])
    keep = ((src != dst) & (src >= 0) & (dst >= 0) & (src < n_nodes)
            & (dst < n_nodes))
    src, dst, weights = src[keep], dst[keep], weights[keep]
    if dedup:
        key = src * n_nodes + dst
        _, first = np.unique(key, return_index=True)
        src, dst, weights = src[first], dst[first], weights[first]
    order = np.lexsort((dst, src))
    src, dst, weights = src[order], dst[order], weights[order]
    row_ptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(row_ptr, src + 1, 1)
    row_ptr = np.cumsum(row_ptr)
    dev = resolve_device(device)
    return CSRGraph(
        row_ptr=torch.from_numpy(row_ptr.astype(np.int32)).to(dev),
        col_idx=torch.from_numpy(dst.astype(np.int32)).to(dev),
        weights=torch.from_numpy(weights).to(dev),
    )

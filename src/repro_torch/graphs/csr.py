"""Compressed Sparse Row graph container and the frontier expansion stage.

Counterpart of ``repro.graphs.csr`` (``CSRGraph``, ``from_edges``,
``EdgeFrontier``, ``frontier_from_mask``, ``frontier_degree_sum``,
``expand_frontier``, the serving stack's ``GraphView`` / ``tile_csr``, and
the edge-partitioned layout ``GraphPartition`` / ``PartitionedGraphView`` /
``partition_csr`` / ``suggest_partitions``).  Arrays are torch tensors on
one device: int32 ids and offsets, float32 weights, as in the reference
(x64 off).

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


# -- edge-partitioned layout -------------------------------------------------
#
# A 1-D block vertex partition with halo (ghost) slots: shard ``p`` owns the
# vertex block [p*block, (p+1)*block) and every edge sourced there, so its
# local CSR is a row-range crop of the global one.  Remote destinations are
# renumbered into sorted ghost slots appended after the owned block (local
# node space: [0, block) owned ++ [block, block + ghost_cap) ghosts), and the
# expansion's padding sentinel (the local node count) lands past the ghosts.
# The boundary exchange (``dist.graph_partition``) ships ghost-slot values to
# their owners along the static (slot, owner-local id) maps built here.


@dataclasses.dataclass(frozen=True)
class GraphPartition:
    """Stacked per-shard CSR slices and static boundary maps (``[P, ...]``).

    Counterpart of ``repro.graphs.csr.GraphPartition``: the same fields,
    dtypes and pads, as torch tensors on one device.
    """

    # per-shard local CSR (leading dim = shard)
    row_ptr: torch.Tensor    # int32[P, local_nodes + 1] (ghost rows degree 0)
    col_idx: torch.Tensor    # int32[P, edge_cap] local dsts; pad local_nodes
    weights: torch.Tensor    # float32[P, edge_cap]
    # ghost directory
    ghost_ids: torch.Tensor  # int32[P, ghost_cap] global id per slot; pad -1
    n_ghosts: torch.Tensor   # int32[P]
    n_local_edges: torch.Tensor  # int32[P] true (unpadded) local edge count
    # boundary maps: lane k of the (shard, owner) pair
    send_slot: torch.Tensor  # int32[P, P, lane_cap] ghost slot; pad
    #                          local_nodes
    send_mask: torch.Tensor  # bool[P, P, lane_cap]
    recv_id: torch.Tensor    # int32[P, P, lane_cap] owner-local id; pad block
    recv_mask: torch.Tensor  # bool[P, P, lane_cap]
    # static geometry
    n_nodes: int = 0
    n_edges: int = 0
    n_parts: int = 1
    block: int = 0
    ghost_cap: int = 0
    lane_cap: int = 0
    edge_cap: int = 0

    _TENSORS = ("row_ptr", "col_idx", "weights", "ghost_ids", "n_ghosts",
                "n_local_edges", "send_slot", "send_mask", "recv_id",
                "recv_mask")

    @property
    def local_nodes(self) -> int:
        """Per-shard local node-space size (owned block + ghost slots)."""
        return self.block + self.ghost_cap

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def shard_graph(self, p: int) -> CSRGraph:
        """Local ``CSRGraph`` of shard ``p`` (views of the stacked arrays)."""
        return CSRGraph(row_ptr=self.row_ptr[p], col_idx=self.col_idx[p],
                        weights=self.weights[p])

    def to(self, device: str | torch.device) -> "GraphPartition":
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device) for k in self._TENSORS})

    def nbytes(self) -> int:
        """Bytes of the stacked arrays (what the partition holds on its
        device)."""
        return sum(getattr(self, k).nbytes for k in self._TENSORS)


@dataclasses.dataclass(frozen=True)
class PartitionedGraphView:
    """A sharded multi-tenant composite: ``partition_csr(tile_csr(g, Q), P)``.

    ``part`` is the ordinary partition of the composite id space (boundary
    maps over composite ids, so ghosts dedupe per tenant) and ``view``
    carries the tenant geometry the partition flattened away.
    """

    part: GraphPartition
    view: GraphView

    @property
    def n_nodes(self) -> int:
        return self.part.n_nodes

    @property
    def n_edges(self) -> int:
        return self.part.n_edges

    @property
    def n_parts(self) -> int:
        return self.part.n_parts

    @property
    def n_tenants(self) -> int:
        return self.view.n_tenants

    @property
    def base_nodes(self) -> int:
        return self.view.base_nodes


def partition_csr(graph: CSRGraph, n_parts: int, *, edge_align: int = 8):
    """Block-partition ``graph`` into ``n_parts`` halo'd CSR slices.

    Every edge lands once, on the shard owning its source; destinations
    outside the owned block become sorted ghost slots.  All shards pad to
    common capacities (most local edges rounded up to ``edge_align``, most
    ghosts, most boundary lanes of one (shard, owner) pair), so the result
    stacks into ``[P, ...]`` tensors: the reference's arrays exactly.

    Unlike the reference (numpy on the host) this runs in torch ops on the
    graph's own device; it reads a handful of scalars on the host.  A
    ``GraphView`` (a ``tile_csr`` composite) gives a
    :class:`PartitionedGraphView`; a plain ``CSRGraph`` the bare
    :class:`GraphPartition`.
    """
    if isinstance(graph, GraphView):
        base = CSRGraph(graph.row_ptr, graph.col_idx, graph.weights)
        return PartitionedGraphView(
            part=partition_csr(base, n_parts, edge_align=edge_align),
            view=graph)
    n_parts = int(n_parts)
    if n_parts < 1:
        raise ValueError(f"partition_csr: n_parts must be >= 1, got {n_parts}")
    n, m = graph.n_nodes, graph.n_edges
    if n_parts > max(n, 1):
        raise ValueError(
            f"partition_csr: n_parts={n_parts} exceeds n_nodes={n} -- shards "
            f"would own no vertices")
    dev, P = graph.device, n_parts
    i32, i64 = torch.int32, torch.int64
    block = -(-n // P) if n else 1
    rp = graph.row_ptr.to(i64)
    shards = torch.arange(P, device=dev)
    lo = (shards * block).clamp(max=n)
    hi = (lo + block).clamp(max=n)
    e0 = rp[lo]
    n_local = rp[hi] - e0

    # every edge's shard (its source's owner) and local position
    src = graph.edge_sources().to(i64)
    dst = graph.col_idx.to(i64)
    shard = src // block
    lane = torch.arange(m, device=dev) - e0[shard]
    owned = (dst // block) == shard
    # ghosts: (shard, dst) keys of remote edges, sorted, so each shard's
    # ghosts are contiguous and ascending, and within a shard each owner's
    ghost_key, ghost_of_edge = torch.unique(
        shard[~owned] * max(n, 1) + dst[~owned], sorted=True,
        return_inverse=True)
    g_shard = ghost_key // max(n, 1)
    g_id = ghost_key % max(n, 1)
    g_owner = g_id // block
    n_ghosts = torch.bincount(g_shard, minlength=P)
    g_slot = (torch.arange(ghost_key.numel(), device=dev)
              - (torch.cumsum(n_ghosts, 0) - n_ghosts)[g_shard])
    pair = torch.bincount(g_shard * P + g_owner, minlength=P * P)
    g_lane = (torch.arange(ghost_key.numel(), device=dev)
              - (torch.cumsum(pair, 0) - pair)[g_shard * P + g_owner])

    # the static capacities: one host read
    ghost_cap, edge_cap, lane_cap = torch.stack(
        [n_ghosts.max(), n_local.max(), pair.max()]).tolist()
    edge_cap = max(edge_align, -(-max(edge_cap, 1) // edge_align) * edge_align)
    local_nodes = block + ghost_cap

    # local row pointers: row r of shard p is global row min(lo + r, hi)
    r = torch.arange(local_nodes + 1, device=dev)
    row_ptr = (rp[torch.minimum(lo[:, None] + r, hi[:, None])]
               - e0[:, None]).to(i32)
    local_dst = dst - lo[shard]
    local_dst[~owned] = block + g_slot[ghost_of_edge]
    flat = shard * edge_cap + lane
    col_idx = torch.full((P * edge_cap,), local_nodes, dtype=i32, device=dev)
    col_idx[flat] = local_dst.to(i32)
    weights = torch.zeros(P * edge_cap, dtype=graph.weights.dtype,
                          device=dev)
    weights[flat] = graph.weights
    ghost_ids = torch.full((P * ghost_cap,), -1, dtype=i32, device=dev)
    ghost_ids[g_shard * ghost_cap + g_slot] = g_id.to(i32)

    send_slot = torch.full((P * P * lane_cap,), local_nodes, dtype=i32,
                           device=dev)
    send_mask = torch.zeros(P * P * lane_cap, dtype=torch.bool, device=dev)
    recv_id = torch.full((P * P * lane_cap,), block, dtype=i32, device=dev)
    recv_mask = torch.zeros(P * P * lane_cap, dtype=torch.bool, device=dev)
    send_at = (g_shard * P + g_owner) * lane_cap + g_lane
    recv_at = (g_owner * P + g_shard) * lane_cap + g_lane
    send_slot[send_at] = (block + g_slot).to(i32)
    send_mask[send_at] = True
    recv_id[recv_at] = (g_id - g_owner * block).to(i32)
    recv_mask[recv_at] = True

    return GraphPartition(
        row_ptr=row_ptr, col_idx=col_idx.reshape(P, edge_cap),
        weights=weights.reshape(P, edge_cap),
        ghost_ids=ghost_ids.reshape(P, ghost_cap),
        n_ghosts=n_ghosts.to(i32), n_local_edges=n_local.to(i32),
        send_slot=send_slot.reshape(P, P, lane_cap),
        send_mask=send_mask.reshape(P, P, lane_cap),
        recv_id=recv_id.reshape(P, P, lane_cap),
        recv_mask=recv_mask.reshape(P, P, lane_cap),
        n_nodes=n, n_edges=m, n_parts=P, block=block, ghost_cap=ghost_cap,
        lane_cap=lane_cap, edge_cap=edge_cap)


def suggest_partitions(graph: CSRGraph, *, vmem_bytes: int = 50 * 2 ** 20,
                       state_arrays: int = 2, max_parts: int = 256) -> int:
    """Smallest power-of-two shard count whose working set fits the budget.

    GraphCage's segment-size-to-cache rule: a shard's resident set is its
    CSR slice (row_ptr + col_idx + weights), ``state_arrays`` node-payload
    arrays over the local node space, and one edge-frontier lane set (ids +
    payload); ghosts are bounded above by min(local edges, remote nodes).
    The reference's arithmetic and parameters; its budget was the TPU's 16
    MiB of VMEM, and the default here is the H100's 50 MiB L2 cache.
    """
    n, m = graph.n_nodes, graph.n_edges
    p = 1
    while p < max_parts:
        b = -(-n // p)
        m_p = -(-m // p)
        ghost = min(m_p, max(n - b, 0))
        local = b + ghost
        bytes_p = ((local + 1) * 4          # row_ptr slice
                   + m_p * 8                # col_idx + weights
                   + local * 4 * state_arrays
                   + m_p * 8)               # expansion lanes (ids + payload)
        if bytes_p <= vmem_bytes:
            break
        p *= 2
    return p

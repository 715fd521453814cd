"""Fault-tolerant multi-tenant graph query serving on the fused datapath.

Counterpart of ``repro.serve.graph_engine`` on one device.  Many concurrent
traversal queries (BFS, SSSP, PPR; different sources, different users) are
multiplexed into one bucketed ``FrontierPipeline`` step, and queries join
and retire mid-flight like decode requests joining a batch slot.

**The query-id lane.**  The engine leases ``query_slots`` lanes over a
composite replica view (``graphs.csr.tile_csr`` -> ``GraphView``): query
``q``'s node ``v`` is composite node ``q * n_nodes + v``, so the merged
frontier is one stream of ``(query, node)`` ids that expansion, degree-sum
prediction, the capacity ladder, the reorder and the merge consume
unchanged, and merging only ever combines lanes within one query.  The
engine takes a plain ``CSRGraph`` (and tiles it), a ``GraphView`` whose
``n_tenants`` equals ``query_slots``, or a ``PartitionedGraphView`` of one.

**Merge families.**  BFS and SSSP share the ``min`` family (BFS runs as
unit-weight shortest paths in f32, turned back into int32 hop labels on
retirement); PPR is the ``add`` family.  With ``fused=True`` (the default)
both families advance in one dispatch per tick: the composite app declares
``filter_op="tagged"`` and a per-step tag table (the tag of a composite id
is its slot's family), so reorder, merge and scatter fold each lane under
its own family in one pass: kernel B2's tagged body in sort mode, kernel
B3's tagged fold in hash mode.  ``fused=False`` runs one step per family
per tick, the split engine the fused one is held against.

**Robustness:** admission control against the top rung's edge budget (a
bounded queue, ``QueueFullError``; a query that can never fit,
``AdmissionError``); overflow quarantine (the largest predicted contributor
is evicted and retried solo after exponential backoff, at most
``max_retries`` times, and an overflowed step's outputs are discarded);
per-query tick budgets and an EWMA straggler deadline; scripted faults
through ``ft.failures.QueryFaultPlan``.  ``run_to_completion`` raises
``TimeoutError`` naming the stuck query ids.

Differences from the reference: ``GraphServeConfig.kernels`` is the port's
one switch between the kernels and their plain versions (the reference's
``gather``); the engine state is updated in place (the reference's
``.at[].set``); each tick reads the host once for the per-slot loads and
once for the finished slots.

**Partitioned serving.**  A ``PartitionedGraphView``
(``partition_csr(tile_csr(g, Q), P)``) with ``fused=True`` runs every tick
over its ``P`` shards (``_PartitionedFusedRuntime``), stitched by the tagged
boundary exchange; the reference runs them under ``shard_map`` on ``P``
devices.  The port steps them in turn on one device, or, given a group mesh
(``mesh=launch.mesh.make_graph_mesh(P, group=...)``), one shard a rank of a
``torch.distributed`` group: every rank builds the engine over the same view
and submits the same queries, keeps the engine's global state replicated,
and steps its own shard (``all_to_all_single`` for the exchange,
``all_reduce`` for the PPR leak, the rung and the overflow, ``all_gather``
of the owned rows after each step).  Admission, eviction, retirement and
extraction then decide the same on every rank; the decisions that read a
clock (straggler deadlines, the quarantine backoff) are agreed through one
``all_reduce`` a tick each.  ``fused=False`` refuses a partitioned view, as
the reference does.

Min-family results are bit-identical to solo runs in every mode; PPR sums
may reassociate within f32 tolerance (the merge grouping depends on the
co-tenants), the same caveat as hardware fp atomics.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.apps.bfs import BFS_APP, UNVISITED
from repro_torch.apps.ppr import ppr_app
from repro_torch.apps.sssp import SSSP_APP
from repro_torch.core.iru import IRUConfig
from repro_torch.core.pipeline import (CapacityPolicy, FrontierApp,
                                       FrontierPipeline, StepResult,
                                       _host_bucket)
from repro_torch.device import resolve_device
from repro_torch.dist.collectives import StackedShards, group_shards
from repro_torch.dist.graph_partition import (AXIS, _boundary_exchange,
                                              _predict, partitioned_superstep)
from repro_torch.ft.failures import QueryFaultInjector, QueryFaultPlan
from repro_torch.ft.supervisor import StragglerClock, backoff_delay
from repro_torch.graphs.csr import (CSRGraph, GraphView, PartitionedGraphView,
                                    tile_csr)

_F32 = torch.float32
_ACC = torch.float64  # the PPR accumulators (``pipeline._scatter``)
_INF = float("inf")


class AdmissionError(RuntimeError):
    """Query can never be admitted (invalid or over-capacity solo)."""


class QueueFullError(AdmissionError):
    """Bounded wait queue overflow: shed load upstream."""


@dataclasses.dataclass(frozen=True)
class _KindSpec:
    family: str        # "min" | "add"
    unit_weight: bool  # min family: traverse with unit edge weights (BFS)


KINDS = {
    "bfs": _KindSpec("min", True),
    "sssp": _KindSpec("min", False),
    "ppr": _KindSpec("add", False),
}


@dataclasses.dataclass
class GraphQuery:
    """One tenant's traversal query."""

    kind: str                 # "bfs" | "sssp" | "ppr"
    source: int
    iters: int = 20           # ppr power iterations
    damping: float = 0.85     # ppr damping
    tick_budget: Optional[int] = None  # per-query deadline in engine ticks
    # filled by the engine
    qid: int = -1
    status: str = "new"       # queued|running|quarantined|done|rejected|
    #                           cancelled|failed
    result: Optional[np.ndarray] = None
    error: Optional[str] = None
    slot: int = -1
    ticks: int = 0            # batched + solo steps consumed
    retries: int = 0          # quarantine retry attempts
    admitted_tick: int = -1
    admitted_time: float = 0.0

    @property
    def done(self) -> bool:
        return self.status == "done"


@dataclasses.dataclass(frozen=True)
class GraphServeConfig:
    """Engine knobs.  ``kernels`` runs the pipeline through the hand-written
    kernels (``False``: their plain versions, on any device)."""

    query_slots: int = 8
    max_queue: int = 64
    fused: bool = True                   # tagged-lane fused datapath; False
    #                                      = one step per family per tick
    mode: str = "baseline"               # reorder stage: baseline|sort|hash
    iru_config: Optional[IRUConfig] = None
    kernels: bool = True
    ragged: bool = True                  # occupancy-aware steps; False pins
    #                                      padded execution
    edge_capacity: Optional[int] = None  # serving edge budget per family
    #                                      step; None = query_slots * n_edges
    capacity_policy: CapacityPolicy = CapacityPolicy(
        n_buckets=4, min_capacity=4096, growth=8)
    default_tick_budget: int = 10_000
    max_retries: int = 3
    backoff_base_s: float = 0.01
    straggler_factor: float = 10.0
    straggler_min_s: float = 30.0        # deadline floor (generous default)
    ewma: float = 0.9


# ---------------------------------------------------------------------------
# composite (multi-query) frontier apps
# ---------------------------------------------------------------------------

def _rows(per_slot: torch.Tensor, n: int) -> torch.Tensor:
    """Per-slot values -> one value per composite node."""
    return per_slot.repeat_interleave(n)


def _min_family_app(Q: int, n: int) -> FrontierApp:
    """BFS+SSSP composite app over the Q-replica graph: f32 distances with a
    per-slot unit-weight flag (BFS lanes relax with weight 1.0)."""

    def init(graph: CSRGraph, source: int):
        dev = graph.device
        dist = torch.full((Q * n,), _INF, dtype=_F32, device=dev)
        dist[source] = 0.0
        mask = torch.zeros(Q * n, dtype=torch.bool, device=dev)
        mask[source] = True
        return {"dist": dist,
                "unit": torch.zeros(Q, dtype=torch.bool, device=dev)}, mask

    def candidate(state, graph: CSRGraph, ef):
        srcs = ef.srcs.clamp(0, Q * n - 1)  # padding lanes carry Q*n
        w = torch.where(state["unit"][srcs // n], 1.0, ef.weights)
        return state["dist"][srcs] + w

    def update(state, new_dist, graph: CSRGraph):
        mask = new_dist < state["dist"]
        return {"dist": new_dist, "unit": state["unit"]}, mask

    return FrontierApp(
        name="mq_min", filter_op="min", target="dist",
        init=init, candidate=candidate, update=update,
        cond=lambda state, mask: mask.any(),
        result=lambda state: state["dist"],
        needs_weights=True)


def _ppr_rank(state_src, state_prev, acc, live, damp, Q, n, graph):
    """The PPR update of every live row: teleport to the seed, damped pushed
    mass, and the slot's dangling mass returned to the seed."""
    live_row = _rows(live, n)
    d = _rows(damp, n)
    dangling = graph.degrees() == 0
    leak = _rows(torch.where(dangling, state_prev, 0.0).reshape(Q, n).sum(1),
                 n)
    new_rank = (1 - d) * state_src + d * acc + d * leak * state_src
    return live_row, new_rank


def _add_family_app(Q: int, n: int) -> FrontierApp:
    """PPR composite app: per-slot personalized teleport/restart, all-nodes
    frontier on live slots, merged fp-add contribution scatter."""

    def init(graph: CSRGraph, source: int):
        dev = graph.device
        state = {k: torch.zeros(Q * n, dtype=_F32, device=dev)
                 for k in ("rank", "src")}
        state["acc"] = torch.zeros(Q * n, dtype=_ACC, device=dev)
        state["live"] = torch.zeros(Q, dtype=torch.bool, device=dev)
        state["damp"] = torch.zeros(Q, dtype=_F32, device=dev)
        return state, torch.zeros(Q * n, dtype=torch.bool, device=dev)

    def candidate(state, graph: CSRGraph, ef):
        deg = graph.degrees().clamp(min=1).to(_F32)
        return (state["rank"] / deg)[ef.srcs.clamp(max=Q * n - 1)]

    def update(state, acc64, graph: CSRGraph):
        acc = acc64.to(_F32)
        live_row, new_rank = _ppr_rank(state["src"], state["rank"], acc,
                                       state["live"], state["damp"], Q, n,
                                       graph)
        rank = torch.where(live_row, new_rank, state["rank"])
        state = {"rank": rank, "src": state["src"],
                 "acc": torch.zeros_like(acc64),
                 "live": state["live"], "damp": state["damp"]}
        return state, live_row

    return FrontierApp(
        name="mq_add", filter_op="add", target="acc",
        init=init, candidate=candidate, update=update,
        cond=lambda state, mask: mask.any(),
        result=lambda state: state["rank"])


def _fused_family_app(Q: int, n: int) -> FrontierApp:
    """Both merge families in one tagged composite app.

    The per-slot ``tag`` (False = min, True = add) makes the tag a function
    of the composite node id (``tag[id // n]``): equal indices share a tag,
    so every duplicate run is uniform-tag.  ``val`` is the min family's
    distance and the add family's rank; ``tgt`` is the shared scatter
    target, in float64: min rows mirror ``val`` (the min fold relaxes in
    place) and add rows reset to 0 each step (a fresh accumulator).
    """

    def init(graph: CSRGraph, source: int):
        dev = graph.device

        def full(v, size, dtype):
            return torch.full((size,), v, dtype=dtype, device=dev)

        state = {"val": full(_INF, Q * n, _F32), "tgt": full(_INF, Q * n, _ACC),
                 "src": full(0.0, Q * n, _F32),
                 "tag": full(False, Q, torch.bool),
                 "unit": full(False, Q, torch.bool),
                 "live": full(False, Q, torch.bool),
                 "damp": full(0.0, Q, _F32)}
        return state, full(False, Q * n, torch.bool)

    def tag_table(state, graph: CSRGraph):
        # bool[Q*n + 1]: the expansion's padding sentinel (Q*n) maps to the
        # min family, per the datapath contract
        return torch.cat([_rows(state["tag"], n),
                          state["tag"].new_zeros(1)])

    def candidate(state, graph: CSRGraph, ef):
        srcs = ef.srcs.clamp(0, Q * n - 1)  # padding lanes carry Q*n
        row = srcs // n
        w = torch.where(state["unit"][row], 1.0, ef.weights)
        deg = graph.degrees().clamp(min=1).to(_F32)
        return torch.where(state["tag"][row], (state["val"] / deg)[srcs],
                           state["val"][srcs] + w)

    def update(state, tgt64, graph: CSRGraph):
        new_tgt = tgt64.to(_F32)  # min rows hold f32 values exactly
        trow = _rows(state["tag"], n)
        # min rows' dangling sums are garbage (inf distances) but feed only
        # their own rows' discarded new_rank lanes
        live_row, new_rank = _ppr_rank(state["src"], state["val"], new_tgt,
                                       state["live"], state["damp"], Q, n,
                                       graph)
        val = torch.where(trow, torch.where(live_row, new_rank, state["val"]),
                          new_tgt)
        mask = torch.where(trow, live_row, new_tgt < state["val"])
        state = dict(state, val=val,
                     tgt=torch.where(trow, 0.0, val).to(_ACC))
        return state, mask

    return FrontierApp(
        name="mq_fused", filter_op="tagged", target="tgt",
        init=init, candidate=candidate, update=update,
        cond=lambda state, mask: mask.any(),
        result=lambda state: state["val"],
        needs_weights=True, tag_table=tag_table)


# ---------------------------------------------------------------------------
# the partitioned fused runtime
# ---------------------------------------------------------------------------

def _pad1(per_slot: torch.Tensor) -> torch.Tensor:
    """Per-slot values plus a zero entry at slot Q (padding rows' slot)."""
    return torch.cat([per_slot, per_slot.new_zeros(1)])


def _partitioned_fused_app(Q: int) -> FrontierApp:
    """The fused composite app over ONE shard's local node space.

    Local geometry rides in the state: ``slot`` (int32[local_nodes], the
    slot of each local node, owned and ghost; padding rows carry Q) and
    ``own`` (bool[local_nodes], owned real composite nodes).  Per-slot
    scalars are the same on every shard.  The PPR dangling leak is a
    per-slot sum over every shard's owned nodes (``leak_q``, the
    reference's ``psum``), computed before any shard updates.  ``tgt`` is
    float64, as in the single-device fused app.
    """

    def init(graph, source):
        raise TypeError(
            "partitioned fused app: state is laid out by the runtime")

    def tag_table(state, graph: CSRGraph):
        # bool[local_nodes + 1]: family per local node (ghosts carry their
        # composite id's family); the last entry is the padding sentinel
        return _pad1(_pad1(state["tag"])[state["slot"]])

    def candidate(state, graph: CSRGraph, ef):
        srcs = ef.srcs.clamp(0, state["slot"].shape[0] - 1)
        slot_row = state["slot"][srcs]
        w = torch.where(_pad1(state["unit"])[slot_row], 1.0, ef.weights)
        deg = graph.degrees().clamp(min=1).to(_F32)
        return torch.where(_pad1(state["tag"])[slot_row],
                           (state["val"] / deg)[srcs], state["val"][srcs] + w)

    def update(state, tgt64, graph: CSRGraph):
        new_tgt = tgt64.to(_F32)  # min rows hold f32 values exactly
        slot, own = state["slot"], state["own"]
        trow = _pad1(state["tag"])[slot]
        live_row = _pad1(state["live"])[slot] & own
        d = _pad1(state["damp"])[slot]
        leak = _pad1(state["leak_q"])[slot]
        new_rank = (1 - d) * state["src"] + d * new_tgt + d * leak * state[
            "src"]
        val = torch.where(trow, torch.where(live_row, new_rank, state["val"]),
                          new_tgt)
        mask = torch.where(trow, live_row, new_tgt < state["val"])
        state = {k: v for k, v in state.items() if k != "leak_q"}
        state.update(val=val, tgt=torch.where(trow, 0.0, val).to(_ACC))
        return state, mask

    return FrontierApp(
        name="mq_fused_part", filter_op="tagged", target="tgt",
        init=init, candidate=candidate, update=update,
        cond=lambda state, mask: mask.any(),
        result=lambda state: state["val"],
        needs_weights=True, tag_table=tag_table)


class _PartitionedFusedRuntime:
    """``FrontierPipeline``'s ``step`` for the fused tick over a
    ``PartitionedGraphView``: the shards held here (all of them, stepped in
    turn, or this rank's one over a group: ``shards``) on this runtime's
    device, with the tagged boundary exchange (exact codec) between the
    scatter and the update.

    The engine keeps its fused state in the global single-device layout;
    each step lays it out over the held shards (owned blocks, ghost slots
    at their family's identity), runs one superstep and gathers every
    shard's owned block back into new global tensors.  The engine's state
    is never written, so an overflowed step is rerun from it at the next
    rung.
    """

    def __init__(self, pview: PartitionedGraphView, *, mode: str,
                 iru_config: Optional[IRUConfig], kernels: bool,
                 capacity_policy: Optional[CapacityPolicy], ragged: bool,
                 device: torch.device, shards=None):
        self.shards = shards or StackedShards(pview.n_parts)
        part = pview.part.to(device)
        self.part = part
        self.Q, self.n = pview.n_tenants, pview.base_nodes
        self.app = _partitioned_fused_app(self.Q)
        self.iru_config = None if mode == "baseline" else dataclasses.replace(
            iru_config or IRUConfig(), mode=mode, filter_op="tagged")
        self.kernels = kernels
        self.ragged = ragged
        self.capacity_policy = capacity_policy or CapacityPolicy()
        # per-shard rungs over the LOCAL capacities; the top rung holds any
        # shard's whole edge set
        self.buckets = self.capacity_policy.ladder(
            max(part.edge_cap, 1), part.local_nodes)
        self.graphs = [part.shard_graph(p) for p in part.held]
        self._degrees = torch.stack([g.degrees() for g in self.graphs])
        # id-space maps [H, local_nodes] of the held shards: global
        # composite id (owned, then the ghosts'), slot (padding -> Q) and
        # the owned-real mask
        Qn, block = self.Q * self.n, part.block
        owned = (torch.arange(part.held.start, part.held.stop,
                              device=device)[:, None] * block
                 + torch.arange(block, device=device))
        gid = torch.cat([torch.where(owned < Qn, owned, -1),
                         part.ghost_ids.long()], 1)
        self._slot = torch.where(gid >= 0, gid // max(self.n, 1), self.Q)
        self._own = torch.zeros_like(gid, dtype=torch.bool)
        self._own[:, :block] = gid[:, :block] >= 0
        self._gid = gid.clamp(0, max(Qn - 1, 0))

    # -- global <-> stacked relayout -----------------------------------------
    def _to_stacked(self, state_g, mask_g):
        gid, own, slot = self._gid, self._own, self._slot
        ident = torch.where(_pad1(state_g["tag"])[slot], 0.0, _INF).to(_ACC)
        val = torch.where(own, state_g["val"][gid], _INF)
        tgt = torch.where(own, state_g["tgt"][gid], ident)
        src = torch.where(own, state_g["src"][gid], 0.0)
        shared = {k: state_g[k] for k in ("tag", "unit", "live", "damp")}
        states = [dict(shared, val=val[h], tgt=tgt[h], src=src[h],
                       slot=slot[h], own=own[h])
                  for h in range(len(self.part.held))]
        return states, own & mask_g[gid]

    def _from_stacked(self, state_g, states, mask_st):
        """The global state after a step: every shard's owned ``val`` and
        mask rows (one ``all_gather`` over a group), ``tgt`` rebuilt from
        ``val`` as the update builds it, and the rest of ``state_g``, which
        a step does not change."""
        Qn, block = self.Q * self.n, self.part.block
        rows = torch.stack([torch.stack([s["val"] for s in states]),
                            mask_st.to(_F32)], 1)[..., :block]
        rows = self.shards.gather(rows).transpose(0, 1).reshape(2, -1)[:, :Qn]
        val = rows[0]
        tgt = torch.where(_rows(state_g["tag"], self.n), 0.0, val).to(_ACC)
        state = dict(state_g, val=val, tgt=tgt)
        return state, rows[1] > 0

    # -- one superstep --------------------------------------------------------
    def _shared(self, states, graphs):
        """Per-slot dangling PPR mass summed over every shard's owned
        nodes (the reference's ``psum`` of ``leak_q``)."""
        leak = states[0]["val"].new_zeros(self.Q + 1)
        for s, g in zip(states, graphs):
            dangling = s["own"] & (g.degrees() == 0)
            leak = leak.index_add(0, s["slot"],
                                  torch.where(dangling, s["val"], 0.0))
        return {"leak_q": self.shards.sum(leak[None])[:self.Q]}

    def _exchange(self, target, states):
        tags = torch.stack([_pad1(s["tag"])[s["slot"]] for s in states])
        out, _ = _boundary_exchange(target, None, part=self.part,
                                    op="tagged", codec="exact", tags=tags,
                                    shards=self.shards)
        return out

    def _superstep(self, states, mask, bucket: int):
        part = self.part
        e_cap, f_cap = self.buckets[bucket]
        exchange = (self._exchange if part.n_parts > 1 and part.lane_cap > 0
                    else None)
        return partitioned_superstep(
            self.graphs, self.app, states, mask, e_cap=e_cap, f_cap=f_cap,
            exchange=exchange, shared=self._shared,
            iru_config=self.iru_config, kernels=self.kernels,
            ragged=self.ragged)

    # -- the host-dispatched step (the engine's pipe.step contract) -----------
    def step(self, state, mask, *, raise_on_overflow: bool = True
             ) -> StepResult:
        """One superstep at the smallest rung holding the largest shard's
        working set, re-dispatched upward on overflow.  On overflow at the
        top (``raise_on_overflow=False``) the given state comes back."""
        states, mk = self._to_stacked(state, mask)
        b = (_host_bucket(self.buckets, *_predict(self._degrees, mk,
                                                  self.shards))
             if len(self.buckets) > 1 else 0)
        none = mk.new_zeros(0, dtype=torch.int32)
        zero = mk.new_zeros((), dtype=torch.int32)
        while True:
            out_states, out_mask, ovf = self._superstep(states, mk, b)
            # any shard's overflow (every rank reads the same sum)
            if not bool(self.shards.sum(ovf.long()[None])):
                gs, gm = self._from_stacked(state, out_states, out_mask)
                return StepResult(gs, gm, none, none, none, zero, False, b)
            if b == len(self.buckets) - 1:
                if raise_on_overflow:
                    raise RuntimeError(
                        "partitioned fused step overflowed the top bucket "
                        f"{self.buckets[b]} -- raise edge capacities")
                return StepResult(state, mask, none, none, none, zero, True,
                                  b)
            b += 1


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class GraphServingEngine:
    """Slot-leased multi-tenant traversal engine (see the module docstring).

    ``device=None`` runs on the card and raises without one; the graph is
    moved to the engine's device.  ``mesh`` (a group mesh,
    ``launch.mesh.make_graph_mesh(P, group=...)``) serves a
    ``PartitionedGraphView`` of ``P`` shards one shard a rank, on the mesh's
    device: every rank of the group builds the engine and makes the same
    calls (``submit``, ``tick``, ``run_to_completion``), each of them a
    collective.  ``mesh=None`` steps every shard here.
    """

    def __init__(
        self,
        graph: CSRGraph,
        config: Optional[GraphServeConfig] = None,
        *,
        fault_plan: Optional[QueryFaultPlan] = None,
        device: str | torch.device | None = None,
        mesh=None,
    ):
        self.cfg = cfg = config or GraphServeConfig()
        if cfg.query_slots < 1:
            raise ValueError(f"query_slots must be >= 1, got {cfg.query_slots}")
        if mesh is not None and not isinstance(graph, PartitionedGraphView):
            raise ValueError(
                f"a mesh shards a PartitionedGraphView (partition_csr("
                f"tile_csr(g, {cfg.query_slots}), P)); a "
                f"{type(graph).__name__} has no shards")
        # a plain CSRGraph (tiled here), a composed GraphView, or a
        # PartitionedGraphView (the fused tick runs over its shards)
        self.part_view: Optional[PartitionedGraphView] = None
        self.shards = None  # one shard a rank: the group's RankShards
        if isinstance(graph, PartitionedGraphView):
            if not cfg.fused:
                raise ValueError(
                    "PartitionedGraphView serving requires fused=True "
                    "(the split per-family engine is single-device only)")
            part = graph.part
            if mesh is None and len(part.held) != part.n_parts:
                raise ValueError(
                    f"serving without a mesh needs every shard; this view "
                    f"holds shards {list(part.held)} of {part.n_parts} (one "
                    f"shard a rank takes a group mesh)")
            if mesh is not None:
                if mesh.shape.get(AXIS) != part.n_parts:
                    raise ValueError(
                        f"mesh axis {AXIS!r} has size "
                        f"{mesh.shape.get(AXIS)}, partition has "
                        f"{part.n_parts} shards")
                self.shards = group_shards(mesh, AXIS)
                if device is not None and torch.device(
                        device) != mesh.devices[0]:
                    raise ValueError(f"device={device!r} against the mesh's "
                                     f"{mesh.devices[0]}")
                device = mesh.devices[0]
                # this rank keeps its own shard's rows alone
                graph = dataclasses.replace(
                    graph, part=part.shard(self.shards.rank))
            self.part_view = graph
            graph = graph.view
        self.device = resolve_device(device)
        view = graph if isinstance(graph, GraphView) else None
        if view is not None:
            if view.n_tenants != cfg.query_slots:
                raise ValueError(
                    f"composed view has n_tenants={view.n_tenants} but the "
                    f"engine leases query_slots={cfg.query_slots} lanes -- "
                    f"tile with tile_csr(g, {cfg.query_slots})")
            graph = view.base
        self.graph = graph.to(self.device)
        self.Q, self.n, self.m = cfg.query_slots, graph.n_nodes, graph.n_edges
        self.cgraph = (view.to(self.device) if view is not None
                       else tile_csr(self.graph, self.Q))
        self.injector = (QueryFaultInjector(fault_plan)
                         if fault_plan is not None else None)
        self.queue: deque[GraphQuery] = deque()
        self.slots: list[Optional[GraphQuery]] = [None] * self.Q
        self.quarantined: list[tuple[GraphQuery, float]] = []  # (q, retry_at)
        self.completed: list[GraphQuery] = []
        self.tick_no = 0
        self.clock = StragglerClock(cfg.straggler_factor, cfg.ewma)
        self._next_qid = 0
        # telemetry
        self.overflow_events = 0
        self.quarantines = 0
        self.admission_blocked = 0
        # family runtimes (composite pipelines share one edge budget each)
        self._edge_budget = (cfg.edge_capacity if cfg.edge_capacity is not None
                             else self.Q * self.m)
        self._pipes: dict[str, FrontierPipeline] = {}
        self._states: dict[str, dict] = {}
        self._masks: dict[str, torch.Tensor] = {}
        self._apps = {"min": _min_family_app(self.Q, self.n),
                      "add": _add_family_app(self.Q, self.n)}
        self._deg = self.graph.degrees()
        self._deg_host = self._deg.cpu().numpy()
        self._solo_pipes: dict[tuple, FrontierPipeline] = {}
        # fused-datapath state (one composite state for both families) and
        # its per-slot loads, read from the device once per mask change
        self._fstate: Optional[dict] = None
        self._fmask: Optional[torch.Tensor] = None
        self._fused_loads: Optional[np.ndarray] = None

    def _pipeline(self, graph: CSRGraph, app: FrontierApp,
                  **kw) -> FrontierPipeline:
        cfg = self.cfg
        return FrontierPipeline(
            graph, app, mode=cfg.mode, iru_config=cfg.iru_config,
            kernels=cfg.kernels, capacity_policy=cfg.capacity_policy,
            ragged=cfg.ragged, device=self.device, **kw)

    def _needs(self, mask: torch.Tensor) -> np.ndarray:
        """Per-slot degree sum of a composite frontier mask (one host read)."""
        return torch.where(mask.reshape(self.Q, self.n), self._deg[None, :],
                           0).sum(1, dtype=torch.int64).cpu().numpy()

    # -- family runtimes (built lazily: a BFS/SSSP-only workload never
    #    builds the add family and vice versa) ----------------------------
    def _family(self, fam: str) -> FrontierPipeline:
        if fam not in self._pipes:
            self._pipes[fam] = self._pipeline(
                self.cgraph, self._apps[fam], edge_capacity=self._edge_budget)
            state, mask = self._apps[fam].init(self.cgraph, 0)
            if fam == "min":  # init seeds composite node 0; engine owns lanes
                state["dist"].fill_(_INF)
                mask.fill_(False)
            self._states[fam] = state
            self._masks[fam] = mask
        return self._pipes[fam]

    def _fused_pipe(self):
        """The single tagged-datapath runtime, shared by both families: a
        ``FrontierPipeline`` over the composite view, or the partitioned
        runtime when serving a ``PartitionedGraphView``."""
        if "fused" not in self._pipes:
            cfg = self.cfg
            app = _fused_family_app(self.Q, self.n)
            if self.part_view is not None:
                self._pipes["fused"] = _PartitionedFusedRuntime(
                    self.part_view, mode=cfg.mode, iru_config=cfg.iru_config,
                    kernels=cfg.kernels, capacity_policy=cfg.capacity_policy,
                    ragged=cfg.ragged, device=self.device,
                    shards=self.shards)
            else:
                self._pipes["fused"] = self._pipeline(
                    self.cgraph, app, edge_capacity=self._edge_budget)
            self._fstate, self._fmask = app.init(self.cgraph, 0)
            self._fused_loads = None
        return self._pipes["fused"]

    def _family_top_cap(self, fam: str) -> int:
        if self.cfg.fused:
            # one shared budget gates both families (the partitioned
            # runtime's rungs are per shard: the global budget gates there)
            return self._edge_budget
        return self._family(fam).buckets[-1][0]

    # -- submission / admission -------------------------------------------
    def _initial_need(self, kind: str, source: int) -> int:
        if KINDS[kind].family == "add":
            return self.m  # all-nodes frontier: every replica edge, always
        return int(self._deg_host[source])

    def submit(self, query: GraphQuery) -> int:
        """Queue a query; loud rejection when it can never be served."""
        if query.kind not in KINDS:
            raise AdmissionError(
                f"unknown query kind {query.kind!r}; have {sorted(KINDS)}")
        if not (0 <= query.source < self.n):
            raise AdmissionError(
                f"source id {query.source} outside [0, {self.n})")
        need = self._initial_need(query.kind, query.source)
        top = self._family_top_cap(KINDS[query.kind].family)
        if need > top:
            raise AdmissionError(
                f"query (kind={query.kind}, source={query.source}) needs "
                f"{need} edge lanes solo but the top "
                f"{KINDS[query.kind].family}-family bucket holds {top}: "
                f"raise edge_capacity")
        if len(self.queue) >= self.cfg.max_queue:
            raise QueueFullError(
                f"wait queue full ({self.cfg.max_queue} queries): shed load")
        query.qid = self._next_qid
        self._next_qid += 1
        query.status = "queued"
        self.queue.append(query)
        return query.qid

    def _running(self, fam: Optional[str] = None) -> list[GraphQuery]:
        return [q for q in self.slots if q is not None
                and (fam is None or KINDS[q.kind].family == fam)]

    def _family_load(self, fam: str) -> np.ndarray:
        """Per-slot predicted next-step edge-lane contribution."""
        needs = np.zeros(self.Q, np.int64)
        if self.cfg.fused:
            if self._fmask is None or not self._running(fam):
                return needs
            if self._fused_loads is None:
                self._fused_loads = self._needs(self._fmask)
            for q in self._running(fam):
                needs[q.slot] = self._fused_loads[q.slot]
            return needs
        if fam == "add":
            for q in self._running("add"):
                needs[q.slot] = self.m
            return needs
        if "min" not in self._pipes or not self._running("min"):
            return needs
        return self._needs(self._masks["min"])

    def _admit(self) -> None:
        """FIFO admission under the capacity gate (head-of-line order keeps
        starvation impossible; a blocked head blocks the queue, counted)."""
        while self.queue:
            free = [s for s, q in enumerate(self.slots) if q is None]
            if not free:
                break
            query = self.queue[0]
            src = query.source
            if self.injector is not None:
                src = self.injector.admitted_source(query.qid, src)
            if not (0 <= src < self.n):
                # poisoned in flight: reject loudly, never expand it
                self.queue.popleft()
                query.status = "rejected"
                query.error = (f"poisoned source id {src} detected at "
                               f"admission (query {query.qid})")
                self.completed.append(query)
                continue
            fam = KINDS[query.kind].family
            need = self._initial_need(query.kind, src)
            load = int(self._family_load(fam).sum())
            if load + need > self._family_top_cap(fam):
                self.admission_blocked += 1
                break  # cannot join yet: wait for tenants to shrink/retire
            self.queue.popleft()
            self._place(query, src, free[0])

    def _place(self, query: GraphQuery, src: int, slot: int) -> None:
        n, kind = self.n, KINDS[query.kind]
        lane = slice(slot * n, (slot + 1) * n)
        seed = slot * n + src
        if self.cfg.fused:
            self._fused_pipe()  # ensure runtime + fused state exist
            st, mask = self._fstate, self._fmask
            add = kind.family == "add"
            st["val"][lane] = 0.0 if add else _INF
            st["val"][seed] = 1.0 if add else 0.0
            st["tgt"][lane] = 0.0 if add else _INF
            if not add:
                st["tgt"][seed] = 0.0
            st["src"][lane] = 0.0
            if add:
                st["src"][seed] = 1.0
            st["tag"][slot] = add
            st["unit"][slot] = kind.unit_weight
            st["live"][slot] = add
            st["damp"][slot] = query.damping if add else 0.0
            mask[lane] = add
            mask[seed] = True
            self._fused_loads = None
        else:
            self._family(kind.family)  # ensure runtime exists
            st, mask = (self._states[kind.family], self._masks[kind.family])
            if kind.family == "min":
                st["dist"][lane] = _INF
                st["dist"][seed] = 0.0
                st["unit"][slot] = kind.unit_weight
                mask[lane] = False
            else:
                for key in ("rank", "src"):
                    st[key][lane] = 0.0
                    st[key][seed] = 1.0
                st["live"][slot] = True
                st["damp"][slot] = query.damping
                mask[lane] = True
            mask[seed] = True
        query.slot = slot
        query.status = "running"
        query.ticks = 0
        query.admitted_tick = self.tick_no
        query.admitted_time = time.monotonic()
        self.slots[slot] = query

    def _clear_lane(self, query: GraphQuery) -> None:
        slot, fam = query.slot, KINDS[query.kind].family
        lane = slice(slot * self.n, (slot + 1) * self.n)
        if self.cfg.fused:
            # an empty lane is an idle min row: +inf val/tgt, no frontier
            st = self._fstate
            st["val"][lane] = _INF
            st["tgt"][lane] = _INF
            st["src"][lane] = 0.0
            for key in ("tag", "unit", "live"):
                st[key][slot] = False
            st["damp"][slot] = 0.0
            self._fmask[lane] = False
            self._fused_loads = None
        elif fam == "min":
            self._states["min"]["dist"][lane] = _INF
            self._masks["min"][lane] = False
        else:
            st = self._states["add"]
            st["rank"][lane] = 0.0
            st["src"][lane] = 0.0
            st["live"][slot] = False
            self._masks["add"][lane] = False
        self.slots[slot] = None
        query.slot = -1

    # -- results -----------------------------------------------------------
    def _extract(self, query: GraphQuery, state) -> np.ndarray:
        n, lo = self.n, query.slot * self.n
        fam = KINDS[query.kind].family
        key = "val" if self.cfg.fused else ("rank" if fam == "add" else "dist")
        # a copy: the lane is cleared in place when the query retires
        row = state[key][lo:lo + n].cpu().numpy().copy()
        if fam == "add" or query.kind == "sssp":
            return row
        lab = np.full(n, UNVISITED, np.int32)
        fin = np.isfinite(row)
        lab[fin] = row[fin].astype(np.int32)
        return lab

    def _finish(self, query: GraphQuery, result: np.ndarray) -> None:
        query.result = result
        query.status = "done"
        if query.slot >= 0:
            self._clear_lane(query)
        self.clock.observe(time.monotonic() - query.admitted_time)
        self.completed.append(query)

    def _cancel(self, query: GraphQuery, reason: str) -> None:
        query.status = "cancelled"
        query.error = reason
        if query.slot >= 0:
            self._clear_lane(query)
        self.completed.append(query)

    # -- overflow quarantine ----------------------------------------------
    def _quarantine_victim(self, fam: Optional[str],
                           needs: np.ndarray) -> GraphQuery:
        # largest predicted contribution; ties break to the newest tenant
        # (evicting the latecomer is the least disruptive choice)
        return max(self._running(fam),
                   key=lambda q: (int(needs[q.slot]), q.admitted_tick))

    def _requeue(self, query: GraphQuery, why: str) -> None:
        """Count a retry; past ``max_retries`` the query fails loudly, else
        it waits out its backoff in quarantine."""
        query.retries += 1
        if query.retries > self.cfg.max_retries:
            query.status = "failed"
            query.error = (f"query {query.qid} exhausted {self.cfg.max_retries}"
                           f" quarantine retries ({why})")
            self.completed.append(query)
            return
        query.status = "quarantined"
        query.error = why
        self.quarantined.append((query, time.monotonic() + backoff_delay(
            self.cfg.backoff_base_s, query.retries)))

    def _quarantine(self, query: GraphQuery, why: str) -> None:
        self.quarantines += 1
        self._clear_lane(query)
        self._requeue(query, why)

    def _solo_pipe(self, query: GraphQuery) -> FrontierPipeline:
        key = ((query.kind,) if KINDS[query.kind].family == "min"
               else (query.kind, query.iters, query.damping))
        if key not in self._solo_pipes:
            app = ({"bfs": BFS_APP, "sssp": SSSP_APP}.get(query.kind)
                   or ppr_app(query.iters, query.damping))
            self._solo_pipes[key] = self._pipeline(self.graph, app)
        return self._solo_pipes[key]

    def _retry_solo(self, query: GraphQuery) -> None:
        """A quarantined query degrades to a single-tenant run at full
        base-graph capacity: bit-identical to a solo ``FrontierPipeline``
        run because it is one, stepped from the host under the tick
        budget."""
        pipe = self._solo_pipe(query)
        state, mask = pipe.init(query.source)
        budget = query.tick_budget or self.cfg.default_tick_budget
        used = 0
        t0 = time.monotonic()
        while used < budget - query.ticks and bool(pipe.app.cond(state, mask)):
            res = pipe.step(state, mask)
            state, mask = res.state, res.mask
            used += 1
        query.ticks += used
        if bool(pipe.app.cond(state, mask)):
            self._requeue(query, f"solo retry exceeded the {budget}-tick "
                                 f"budget")
            return
        query.result = pipe.app.result(state).cpu().numpy().copy()
        query.status = "done"
        self.clock.observe(time.monotonic() - t0)
        self.completed.append(query)

    def _agree(self, flags: list[bool]) -> list[bool]:
        """Decisions read off this process's clock, made the same on every
        rank of a group (any rank's True wins: one ``all_reduce``); the
        flags' count is the same on every rank, as the state it ranges over
        is."""
        if self.shards is None or not flags:
            return flags
        got = self.shards.max(torch.tensor([flags], dtype=torch.int32,
                                            device=self.device))
        return [bool(f) for f in got.tolist()]

    def _drain_quarantine(self) -> None:
        now = time.monotonic()
        due = self._agree([t <= now for _, t in self.quarantined])
        waiting = self.quarantined
        self.quarantined = [e for e, d in zip(waiting, due) if not d]
        for (q, _), d in zip(waiting, due):
            if d:
                self._retry_solo(q)

    # -- the tick ----------------------------------------------------------
    def _shed(self, fam: Optional[str], needs: np.ndarray, top: int,
              what: str) -> np.ndarray:
        """Pre-dispatch gate: frontiers grow mid-flight, so evict the
        largest tenants until the merged frontier fits the budget again."""
        while int(needs.sum()) > top:
            self.overflow_events += 1
            self._quarantine(
                self._quarantine_victim(fam, needs),
                f"merged frontier degree sum {int(needs.sum())} exceeds the "
                f"{what} {top} at tick {self.tick_no}")
            needs = self._merged_loads(fam)
        return needs

    def _merged_loads(self, fam: Optional[str]) -> np.ndarray:
        if fam is None:
            return self._family_load("min") + self._family_load("add")
        return self._family_load(fam)

    def _dispatch(self, fam: Optional[str], pipe, state, mask):
        """Gate, step and quarantine for one dispatch (``fam=None``: the
        fused tick).  ``state`` and ``mask`` are the live engine tensors,
        which quarantine clears in place.  Returns the step's result, or
        None when nothing committed."""
        needs = self._merged_loads(fam)
        top = self._family_top_cap(fam or "min")
        if self.injector is not None and self.injector.force_overflow(
                self.tick_no):
            self.overflow_events += 1
            self._quarantine(
                self._quarantine_victim(fam, needs),
                f"injected capacity overflow at tick {self.tick_no}")
            return None  # the overflowed step's outputs would be garbage
        needs = self._shed(fam, needs, top, "serving edge budget"
                           if fam is None else "top bucket capacity")
        if not self._running(fam):
            return None
        res = pipe.step(state, mask, raise_on_overflow=False)
        if bool(res.overflow):
            # reachable only if the gate's prediction was wrong: still no
            # silent truncation, still no co-tenant poisoning
            self.overflow_events += 1
            self._quarantine(self._quarantine_victim(fam, needs),
                             f"step overflow at tick {self.tick_no}")
            return None
        for q in self._running(fam):
            q.ticks += 1
        return res

    def _retire(self, fam: str, state, mask) -> None:
        if fam == "min":
            alive = mask.reshape(self.Q, self.n).any(1).cpu().numpy()
            for q in self._running("min"):
                if not alive[q.slot]:
                    self._finish(q, self._extract(q, state))
        else:
            for q in self._running("add"):
                if q.ticks >= q.iters:
                    self._finish(q, self._extract(q, state))

    def _fused_tick(self) -> None:
        """One fused step: both families advance in one bucketed dispatch,
        gated by the shared edge budget."""
        pipe = self._fused_pipe()
        res = self._dispatch(None, pipe, self._fstate, self._fmask)
        if res is None:
            return
        self._fstate, self._fmask = res.state, res.mask
        self._fused_loads = None
        self._retire("min", self._fstate, self._fmask)
        self._retire("add", self._fstate, self._fmask)

    def _family_tick(self, fam: str) -> None:
        pipe = self._family(fam)
        res = self._dispatch(fam, pipe, self._states[fam], self._masks[fam])
        if res is None:
            return
        self._states[fam], self._masks[fam] = res.state, res.mask
        self._retire(fam, res.state, res.mask)

    def _supervise(self) -> None:
        deadline = self.clock.deadline(self.cfg.straggler_min_s)
        # (query, reason) in slot order; a None reason waits on its age
        verdicts, ages = [], []
        for q in self._running():
            if self.injector is not None:
                self.injector.stall(q.qid, self.tick_no)
                if self.injector.should_cancel(q.qid, self.tick_no):
                    verdicts.append((q, f"cancelled mid-flight at tick "
                                        f"{self.tick_no}"))
                    continue
            budget = q.tick_budget or self.cfg.default_tick_budget
            if q.ticks >= budget:
                verdicts.append((q, f"tick budget {budget} exhausted"))
            elif deadline is not None:
                ages.append(time.monotonic() - q.admitted_time)
                verdicts.append((q, None))
        # every running query's deadline agreed in one call a tick
        late = iter(zip(self._agree([a > deadline for a in ages]), ages))
        for q, reason in verdicts:
            if reason is None:
                over, age = next(late)
                if not over:
                    continue
                reason = (f"straggler deadline exceeded ({age:.3f}s > "
                          f"{deadline:.3f}s EWMA wall-clock bound)")
            self._cancel(q, reason)

    def tick(self) -> int:
        """One engine tick: drain quarantine, admit, one batched step per
        active family (one in all when fused), supervise deadlines.
        Returns the in-flight count."""
        self.tick_no += 1
        self._drain_quarantine()
        self._admit()
        if self.cfg.fused:
            if self._running():
                self._fused_tick()
        else:
            for fam in ("min", "add"):
                if self._running(fam):
                    self._family_tick(fam)
        self._supervise()
        return (sum(q is not None for q in self.slots) + len(self.queue)
                + len(self.quarantined))

    def run_to_completion(self, max_ticks: int = 10_000) -> list[GraphQuery]:
        """Drive until every query resolves; loud on a stuck engine."""
        for _ in range(max_ticks):
            if self.tick() == 0:
                return self.completed
        stuck = sorted(
            [q.qid for q in self.slots if q is not None]
            + [q.qid for q in self.queue]
            + [q.qid for q, _ in self.quarantined])
        raise TimeoutError(
            f"graph engine exhausted max_ticks={max_ticks} with queries "
            f"still in flight: qids={stuck}")

    # -- convenience -------------------------------------------------------
    def solo_reference(self, query: GraphQuery) -> np.ndarray:
        """The solo ``FrontierPipeline`` result this query's engine result
        must match (the parity oracle of the fault tests)."""
        return self._solo_pipe(query).run(query.source).cpu().numpy().copy()

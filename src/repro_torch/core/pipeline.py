"""Device-resident frontier pipeline: expand -> reorder -> merge -> update.

Counterpart of ``repro.core.pipeline``.  One step composes:

* **expand** -- ``graphs.csr.expand_frontier``, through the block-reuse
  gather (kernel B1);
* **reorder** -- ``core.iru.iru_reorder``: the sort engine
  (``mode="sort"``) or the paper's hash engine (``mode="hash"``, kernel B3);
* **filter/merge** -- inside the engine: ``core.filter.merge_sorted``
  after the sort (kernel B2), or the hash walk's own fold (B3);
* **update** -- the merged scatter and the app's frontier rule (a
  ``FrontierApp``).

``kernels=False`` runs the kernels' plain versions instead, on any device:
the plain path a card run is held against.

The reference runs the traversal as a jitted ``lax.while_loop`` per
capacity bucket.  Here ``run`` is a host loop that reads the convergence flag
and, with more than one bucket, the ``(degree sum, node count)`` prediction
once per iteration; the bucket choice and its down-hop hysteresis are the
reference's rule exactly, so every iteration runs at the same capacity as in
the reference and results match.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.filter import _merge_init
from repro_torch.core.iru import IRUConfig, iru_reorder
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import (
    CSRGraph,
    expand_frontier,
    frontier_degree_sum,
    frontier_from_mask,
)

State = dict  # app-defined dict of tensors

_SCATTER_REDUCE = {"min": "amin", "max": "amax"}


def _scatter(target: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
             act: torch.Tensor, op: str,
             tags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Merged scatter: inactive lane ``i`` goes to its own sink slot
    ``n + i`` of an ``n + lanes`` buffer, which is sliced off (the
    reference's ``mode="drop"``).  One shared sink slot would take every
    merged-out lane's atomic on one address, and on the card those
    serialise.

    ``op="tagged"`` is the fused-family scatter: each lane folds under its
    family (``tags``: False = min, True = add).  A destination index has one
    family, so the min scatter (add lanes sent to their sinks) and the add
    scatter (min lanes sent to theirs) compose without interference.
    """
    if op == "tagged":
        if tags is None:
            raise ValueError("op='tagged' requires per-lane tags")
        out = _scatter(target, idx, val, act & ~tags, "min")
        return _scatter(out, idx, val, act & tags, "add")
    if op != "add" and op not in _SCATTER_REDUCE:
        raise ValueError(f"unknown merge op {op!r}")
    n, lanes = target.shape[0], idx.shape[0]
    sink = torch.arange(n, n + lanes, device=idx.device)
    dest = torch.where(act, idx.long(), sink)
    # lanes fold in the target's dtype.  The PPR apps keep a float64
    # accumulator: the card's atomics add a hub's f32 contributions in no
    # fixed order, and summed in float64 and rounded once, the order moves
    # the f32 result far less than an f32 sum's order does
    val = val.to(target.dtype)
    buf = torch.cat([target, target.new_full((lanes,), _merge_init(
        op, target.dtype))])
    if op == "add":
        buf.index_add_(0, dest, val)
    else:
        buf.scatter_reduce_(0, dest, val, reduce=_SCATTER_REDUCE[op],
                            include_self=True)
    return buf[:n]


def _lane_tags(tag_table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each lane's family from the step's tag table (sentinels clamp in
    range: the table's last entry covers the padding index)."""
    return tag_table[idx.long().clamp(0, tag_table.shape[0] - 1)]


@dataclasses.dataclass(frozen=True)
class CapacityPolicy:
    """Geometric ladder of step capacities (the bucketing knob).

    Rung ``c`` expands into ``c`` edge lanes and compacts the node frontier
    to ``min(c, n_nodes)`` lanes; rungs grow from ``min_capacity`` by
    ``growth`` and the top rung is always the full ``edge_capacity``.
    ``hysteresis`` is the down-hop margin: a run leaves its rung for a
    smaller one only once the frontier fits the rung below with this factor
    to spare.  The default is one bucket at full capacity.
    """

    n_buckets: int = 1
    min_capacity: int = 4096
    growth: int = 8
    hysteresis: float = 1.5

    def __post_init__(self):
        if self.n_buckets < 1:
            raise ValueError(f"n_buckets must be >= 1, got {self.n_buckets}")
        if self.min_capacity < 1:
            raise ValueError(
                f"min_capacity must be >= 1, got {self.min_capacity}")
        if self.growth < 2:
            raise ValueError(f"growth must be >= 2, got {self.growth}")
        if self.hysteresis < 1.0:
            raise ValueError(
                f"hysteresis must be >= 1.0, got {self.hysteresis}")

    def ladder(self, edge_capacity: int,
               n_nodes: int) -> tuple[tuple[int, int], ...]:
        """Ascending ``(edge_cap, node_cap)`` rungs, top = full capacity."""
        caps: list[int] = []
        c = self.min_capacity
        for _ in range(self.n_buckets - 1):
            if c >= edge_capacity:
                break
            caps.append(int(c))
            c *= self.growth
        caps.append(int(edge_capacity))
        return tuple(
            (ec, n_nodes if ec == edge_capacity else min(ec, n_nodes))
            for ec in caps)


def frontier_step(
    g: CSRGraph,
    app: "FrontierApp",
    state: State,
    mask: torch.Tensor,
    *,
    e_cap: int,
    f_cap: int,
    iru_config: Optional[IRUConfig] = None,
    kernels: bool = True,
    ragged: bool = True,
):
    """One expand -> candidate -> reorder -> merge-scatter -> update step at
    one capacity rung ``(e_cap, f_cap)``.

    Apps with ``filter_op == "tagged"`` (the fused min+add datapath) must
    declare a ``tag_table``; the table is built once a step and rides the
    reorder engines, which re-derive lane tags from their own index frames,
    so every duplicate run is uniform-tag.

    Returns ``(state, mask, idx, act, real, n_edges, overflow)``.
    """
    n = g.n_nodes
    tag_tab = None
    if app.filter_op == "tagged":
        if app.tag_table is None:
            raise ValueError(
                f"app {app.name!r} has filter_op='tagged' but no tag_table")
        tag_tab = app.tag_table(state, g)
    nodes = frontier_from_mask(mask, size=f_cap)
    ef = expand_frontier(g, nodes, edge_capacity=e_cap,
                         gather="kernel" if kernels else "torch",
                         with_weights=app.needs_weights)
    vals = app.candidate(state, g, ef)
    inert = vals.new_full((), _merge_init(app.filter_op, vals.dtype))
    if tag_tab is not None:
        # dead lanes of the add family hold the add identity (0), not +inf;
        # padding lanes (index n) map to the min family
        inert = torch.where(_lane_tags(tag_tab, ef.dsts),
                            vals.new_full((), _merge_init("add", vals.dtype)),
                            inert)
    vals = torch.where(ef.valid, vals, inert)
    n_edges = ef.n_valid
    if iru_config is None:
        idx, svals, act = ef.dsts, vals, ef.valid
        real = ef.valid
    else:
        # padding lanes carry the sentinel index n; ragged execution treats
        # them as dead lanes (inactive at the tail, never merged), a padded
        # stream as ordinary elements that the scatter drops
        stream = iru_reorder(ef.dsts, vals, config=iru_config,
                             n_live=ef.n_valid if ragged else None,
                             tag_table=tag_tab, kernels=kernels)
        idx, svals = stream.indices, stream.secondary
        act = stream.active & (stream.indices < n)
        # expansion front-packs valid lanes: a lane is real iff its original
        # position is below the valid count
        real = stream.positions < n_edges
    new_target = _scatter(state[app.target], idx, svals, act, app.filter_op,
                          None if tag_tab is None else _lane_tags(tag_tab, idx))
    state, mask = app.update(state, new_target, g)
    return state, mask, idx, act, real, n_edges, ef.overflow


class StepResult(NamedTuple):
    """One dispatched pipeline step (see :meth:`FrontierPipeline.step`).

    On ``overflow=True`` (only with ``raise_on_overflow=False``) ``state`` /
    ``mask`` are the UNCHANGED inputs.
    """

    state: Any
    mask: torch.Tensor
    idx: torch.Tensor
    act: torch.Tensor
    real: torch.Tensor
    n_edges: torch.Tensor
    overflow: bool
    bucket: int


@dataclasses.dataclass(frozen=True)
class FrontierApp:
    """Declarative frontier app: what varies between BFS / SSSP / PageRank.

    * ``init(graph, source)`` -> ``(state, mask)`` on the graph's device;
    * ``candidate(state, graph, ef)`` -> per-lane payload ``[edge_capacity]``
      (invalid lanes are overwritten with the merge identity);
    * ``target``: state key the merged stream scatters into (``filter_op``
      is both the merge op and the scatter op);
    * ``update(state, new_target, graph)`` -> ``(state, mask)``;
    * ``cond(state, mask)`` -> bool 0-d tensor: keep iterating?
    * ``result(state)`` -> the app's output tensor;
    * ``atomic``: whether the recorded irregular access is an atomic
      (SSSP/PR scatters) or a plain load (BFS label lookups); only
      :meth:`FrontierPipeline.run_instrumented` reads it;
    * ``needs_weights``: expansion co-gathers edge weights into ``ef.weights``;
    * ``tag_table(state, graph)`` (required iff ``filter_op == "tagged"``)
      -> bool ``[n_nodes + 1]``: each destination index's merge family
      (False = min, True = add; the last entry covers the padding sentinel
      and is False).
    """

    name: str
    filter_op: str
    target: str
    init: Callable[[CSRGraph, int], tuple[State, torch.Tensor]]
    candidate: Callable[[State, CSRGraph, Any], torch.Tensor]
    update: Callable[[State, torch.Tensor, CSRGraph],
                     tuple[State, torch.Tensor]]
    cond: Callable[[State, torch.Tensor], torch.Tensor]
    result: Callable[[State], torch.Tensor]
    atomic: bool = True
    needs_weights: bool = False
    tag_table: Optional[Callable[[State, CSRGraph], torch.Tensor]] = None


class FrontierPipeline:
    """Bucketed frontier runtime over one (graph, app) pair.

    ``mode`` selects the reorder stage: ``"baseline"`` (none; the raw
    expansion stream scatters directly), ``"sort"`` (the stable-sort engine
    and kernel B2's merge) or ``"hash"`` (the IRU hash, kernel B3).  The
    host oracle ``"hash_ref"`` is not a pipeline mode.  ``kernels`` runs
    the expansion gather and the reorder through the kernels (``False``:
    their plain versions on any device).  ``ragged`` passes the expansion's
    live lane count to the reorder engine; without it the engine sees the
    padded stream, whose sentinel lanes (index ``n``) are ordinary elements
    dropped at the scatter.

    ``device=None`` runs on the card and raises without one; the graph is
    moved to the pipeline's device.
    """

    def __init__(
        self,
        graph: CSRGraph,
        app: FrontierApp,
        *,
        mode: str = "baseline",
        iru_config: Optional[IRUConfig] = None,
        max_iters: Optional[int] = None,
        edge_capacity: Optional[int] = None,
        capacity_policy: Optional[CapacityPolicy] = None,
        kernels: bool = True,
        ragged: bool = True,
        device: str | torch.device | None = None,
    ):
        if mode not in ("baseline", "sort", "hash"):
            raise ValueError(
                f"mode must be baseline|sort|hash, got {mode!r} (hash_ref "
                f"is the host oracle; use the apps' host functions)")
        self.device = resolve_device(device)
        self.graph = graph.to(self.device)
        self.app = app
        self.mode = mode
        self.max_iters = graph.n_nodes if max_iters is None else max_iters
        self.edge_capacity = (graph.n_edges if edge_capacity is None
                              else edge_capacity)
        self.kernels = kernels
        self.iru_config = None if mode == "baseline" else dataclasses.replace(
            iru_config or IRUConfig(), mode=mode, filter_op=app.filter_op)
        self.ragged = ragged
        self.capacity_policy = capacity_policy or CapacityPolicy()
        self.buckets = self.capacity_policy.ladder(self.edge_capacity,
                                                   graph.n_nodes)
        self.n_hops = 0  # host bucket dispatches across run() calls

    # -- bucket dispatch ---------------------------------------------------
    def _predict(self, mask: torch.Tensor) -> tuple[int, int]:
        """Next iteration's exact working set (degree sum, node count): one
        host read."""
        both = torch.stack([frontier_degree_sum(self.graph, mask),
                            mask.sum(dtype=torch.int32)])
        need, count = both.tolist()
        return need, count

    def _host_bucket(self, need: int, count: int) -> int:
        for i, (e_cap, f_cap) in enumerate(self.buckets):
            if need <= e_cap and count <= f_cap:
                return i
        return len(self.buckets) - 1

    def _stays(self, bucket: int, need: int, count: int) -> bool:
        """The reference's in-loop rule for keeping the current rung: the
        frontier still fits it, and (below the top) it does not yet fit the
        rung below with the hysteresis margin."""
        top = len(self.buckets) - 1
        shrunk = self.edge_capacity < self.graph.n_edges
        ok = True
        if bucket < top or shrunk:
            e_cap, f_cap = self.buckets[bucket]
            ok = need <= e_cap and count <= f_cap
        if bucket > 0:
            pe_cap, pf_cap = self.buckets[bucket - 1]
            h = self.capacity_policy.hysteresis
            ok = ok and (need > int(pe_cap / h) or count > int(pf_cap / h))
        return ok

    def _step_impl(self, state, mask, bucket: int):
        e_cap, f_cap = self.buckets[bucket]
        return frontier_step(self.graph, self.app, state, mask, e_cap=e_cap,
                             f_cap=f_cap, iru_config=self.iru_config,
                             kernels=self.kernels, ragged=self.ragged)

    # -- public entry points -------------------------------------------------
    def init(self, source: int = 0) -> tuple[State, torch.Tensor]:
        return self.app.init(self.graph, source)

    def run(self, source: int = 0) -> torch.Tensor:
        """Whole traversal: one step per iteration at the reference's rung.

        A rung is re-chosen on the host only when the frontier leaves it (the
        reference's return from its per-rung ``while_loop``).
        """
        state, mask = self.init(source)
        shrunk = self.edge_capacity < self.graph.n_edges
        bucketed = len(self.buckets) > 1 or shrunk
        bucket = 0
        entered = False
        it = 0
        while it < self.max_iters and bool(self.app.cond(state, mask)):
            if bucketed:
                need, count = self._predict(mask)
                if not (entered and self._stays(bucket, need, count)):
                    if shrunk and need > self.buckets[-1][0]:
                        raise RuntimeError(
                            f"frontier degree sum {need} overflows the "
                            f"shrunk edge_capacity={self.edge_capacity}: "
                            f"edges would be dropped -- raise edge_capacity")
                    bucket = self._host_bucket(need, count)
                    self.n_hops += 1
                    entered = True
            state, mask, *_ = self._step_impl(state, mask, bucket)
            it += 1
        return self.app.result(state)

    def step(self, state, mask, *,
             raise_on_overflow: bool = True) -> StepResult:
        """One step at the smallest fitting bucket, re-dispatched upward on
        overflow (reachable only with a caller-shrunk ``edge_capacity``)."""
        if len(self.buckets) == 1 and self.edge_capacity >= self.graph.n_edges:
            return StepResult(*self._step_impl(state, mask, 0)[:-1], False, 0)
        b = self._host_bucket(*self._predict(mask))
        while True:
            out = self._step_impl(state, mask, b)
            if not bool(out[-1]):  # overflow flag
                return StepResult(*out[:-1], False, b)
            if b == len(self.buckets) - 1:
                if raise_on_overflow:
                    raise RuntimeError(
                        f"expansion overflowed the top bucket "
                        f"(edge_capacity={self.edge_capacity}): the "
                        f"frontier's degree sum exceeds the capacity -- "
                        f"raise edge_capacity")
                return StepResult(state, mask, out[2], out[3], out[4],
                                  out[5], True, b)
            b += 1

    def run_instrumented(self, source: int = 0, *,
                         recorder=None) -> torch.Tensor:
        """Host-stepped traversal that feeds a ``apps.trace.TraceRecorder``
        one event a step: the single instrumentation point for baseline,
        sort and hash measurement.

        Every step goes through :meth:`step`, so its rung is the smallest
        that fits that step's frontier (``run``'s down-hop hysteresis is not
        kept, as in the reference).  Each event is cropped to the real
        lanes, so it carries exactly the accesses the traversal issues
        (capacity padding is free), and hands the recorder tensors on the
        pipeline's device with the app's access kind (``app.atomic``);
        outside ``baseline`` the step's live edge count goes to
        ``recorder.processed``.
        """
        state, mask = self.init(source)
        it = 0
        while it < self.max_iters and bool(self.app.cond(state, mask)):
            r = self.step(state, mask)
            state, mask = r.state, r.mask
            it += 1
            if recorder is not None:
                if self.mode != "baseline":
                    recorder.processed(int(r.n_edges))
                recorder.access(r.idx[r.real], r.act[r.real],
                                atomic=self.app.atomic)
        return self.app.result(state)

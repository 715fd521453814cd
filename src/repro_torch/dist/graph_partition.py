"""Edge-partitioned frontier pipeline with a compressed boundary exchange.

Counterpart of ``repro.dist.graph_partition``.  ``graphs.csr.partition_csr``
splits the CSR into halo'd shards (an owned vertex block plus ghost slots
for remote destinations), and :class:`PartitionedFrontierPipeline` runs the
single-device step on every shard -- the same ``CapacityPolicy`` rungs, the
same ragged path, kernels B1, B2 and B3 launched per shard -- stitching the
shards together with one boundary exchange a superstep.

The reference runs one shard per device under ``shard_map`` (one process
drives them all) and exchanges with an all-to-all.  The port lays its shards
out one of two ways (``dist.collectives``), and one superstep serves both:

* stacked (no mesh, the default): one process holds the ``[P, ...]``
  partition on one device and steps every shard in turn; the all-to-all of
  the ``[P, P, lane_cap]`` send buffer (shard ``o`` receives ``send[p][o]``
  from every ``p``) is its transpose, and the reference's cross-shard
  reductions (``psum``/``pmax``) are sums and maxima over the shard axis;
* one shard per rank (a group mesh, ``launch.mesh.make_graph_mesh(P,
  group=...)``): each rank of a ``torch.distributed`` group holds only its
  own shard (:meth:`GraphPartition.shard`), state and error-feedback rows;
  the exchange is ``all_to_all_single`` of the codec's wire, one call a
  wire array, and the reductions are ``all_reduce``s.  Every rank makes the
  same two host reads a superstep as the stacked path (the rung, and
  convergence with overflow) and ends with the global result.

The exchange is value-only: the partitioner froze the (ghost slot -> owner
local id) maps, so each superstep ships the app payload per boundary lane,
never ids, and ``compress=True`` picks the app's codec:

* ``flag`` -- BFS: every candidate is the same ``depth + 1`` (supersteps run
  in lockstep), so one int8 presence flag a lane rebuilds it exactly on the
  receiver: 4x less traffic, still bit-identical;
* ``int8_ef`` -- PageRank: blockwise int8 (one f32 scale per 128 lanes) with
  a per-lane error-feedback buffer carried across supersteps: ~3.9x less
  traffic, results allclose;
* SSSP keeps ``exact`` even under ``compress=True``: f32 distances have no
  exact small encoding, and BFS/SSSP parity with one device is absolute.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.filter import _merge_init
from repro_torch.core.iru import IRUConfig
from repro_torch.core.pipeline import (CapacityPolicy, FrontierApp,
                                       _host_bucket, _scatter,
                                       frontier_scatter)
from repro_torch.device import resolve_device
from repro_torch.dist.collectives import StackedShards, group_shards
from repro_torch.graphs.csr import (CSRGraph, GraphPartition,
                                    PartitionedGraphView, partition_csr)

AXIS = "gpart"  # the graph-shard mesh axis (launch.mesh.make_graph_mesh)
_QBLOCK = 128  # int8 codec block (one f32 scale per 128 lanes)


# -- boundary payload codecs --------------------------------------------------

def quantize_rows_i8(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise-int8 quantize each row of ``y`` [R, K] independently.

    Rows stay separable (each row of the send buffer goes to another
    shard); blocks of 128 consecutive lanes share one f32 scale.  Returns
    ``(q int8 [R, K], scale f32 [R, ceil(K/128)])``.  Rounds half to even,
    as ``jnp.round`` does, so ``q`` equals the reference's bit for bit.
    """
    r, k = y.shape
    nb = -(-k // _QBLOCK)
    yb = torch.nn.functional.pad(y, (0, nb * _QBLOCK - k)).reshape(
        r, nb, _QBLOCK)
    scale = yb.abs().amax(-1, keepdim=True) / 127.0
    q = torch.round(yb / scale.clamp(min=1e-20)).to(torch.int8)
    return q.reshape(r, nb * _QBLOCK)[:, :k], scale[..., 0]


def dequantize_rows_i8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    r, k = q.shape
    nb = scale.shape[1]
    qb = torch.nn.functional.pad(q, (0, nb * _QBLOCK - k))
    y = qb.reshape(r, nb, _QBLOCK).to(torch.float32) * scale[..., None]
    return y.reshape(r, nb * _QBLOCK)[:, :k]


def _encode(codec: str, send: torch.Tensor, ef: torch.Tensor,
            ident) -> tuple[dict, torch.Tensor]:
    """Send buffer ``[R, K]`` -> wire dict (+ the new error-feedback
    buffer)."""
    if codec == "exact":
        return {"v": send}, ef
    if codec == "flag":
        return {"f": (send != ident).to(torch.int8)}, ef
    if codec == "int8_ef":
        y = send.to(torch.float32) + ef
        q, scale = quantize_rows_i8(y)
        return {"q": q, "s": scale}, y - dequantize_rows_i8(q, scale)
    raise ValueError(f"unknown boundary codec {codec!r}")


def _decode(codec: str, wire: dict, ident, dtype: torch.dtype,
            payload) -> torch.Tensor:
    """Wire dict -> received values ``[R, K]``.  ``flag`` rebuilds each lane
    from the RECEIVER's ``payload`` (a scalar, or one per row), exact
    because supersteps advance in lockstep."""
    if codec == "exact":
        return wire["v"]
    if codec == "flag":
        f = wire["f"]
        return torch.where(f != 0, torch.as_tensor(payload, dtype=dtype,
                                                   device=f.device),
                           torch.as_tensor(ident, dtype=dtype,
                                           device=f.device))
    return dequantize_rows_i8(wire["q"], wire["s"]).to(dtype)


def _wire_bytes(codec: str, lanes: int, itemsize: int) -> int:
    """Wire bytes for ``lanes`` boundary lanes of one (shard, peer) row."""
    if codec == "flag":
        return lanes
    if codec == "int8_ef":
        return lanes + 4 * -(-lanes // _QBLOCK)
    return lanes * itemsize


def _boundary_exchange(new_target: torch.Tensor, ef_buf: torch.Tensor, *,
                       part: GraphPartition, op: str, codec: str,
                       payload=None, tags: Optional[torch.Tensor] = None,
                       shards=None):
    """One exchange of boundary values over the shards ``part`` holds (``H``
    of them: all ``P``, or this rank's one); returns ``(merged target [H,
    local_nodes], new error-feedback buffer)``.

    ``new_target`` is each held shard's post-scatter target: its ghost
    region ``[block:]`` holds the shard's outbound contributions (it started
    the superstep at the merge identity).  Gather them along ``send_slot``
    under ``send_mask`` (the identity elsewhere), encode, send row ``o`` to
    shard ``o`` through ``shards.all_to_all`` (the reference's all-to-all:
    a transpose when stacked, ``all_to_all_single`` of each wire array over
    a group), decode, merge into the owned blocks along ``recv_id`` under
    ``recv_mask`` with the app's op (padding ``recv_id == block`` drops at
    the scatter's sink slots), and reset the ghost regions to the identity.

    ``payload`` is ``[H]``, one per receiving shard (the ``flag`` codec's).
    ``op="tagged"`` is the fused-family exchange: ``tags`` (bool ``[H,
    local_nodes]``, False = min, True = add) gives each slot its family and
    identity; it takes the exact codec only.  ``shards`` defaults to the
    stacked layout of every shard.
    """
    H, ln = new_target.shape
    P, block, k = part.n_parts, part.block, part.lane_cap
    shards = shards or StackedShards(P)
    if (op == "tagged") != (tags is not None):
        raise ValueError("op='tagged' and a local tag table go together")
    if op == "tagged" and codec != "exact":
        raise ValueError(
            f"tagged boundary exchange supports only the exact codec, "
            f"got {codec!r}")
    ident = _merge_init(op, new_target.dtype)
    slots = part.send_slot.clamp(max=ln - 1).reshape(H, P * k).long()
    picked = torch.gather(new_target, 1, slots).reshape(H, P, k)
    if op == "tagged":
        slot_ident = torch.where(
            tags, new_target.new_full((), _merge_init("add",
                                                      new_target.dtype)),
            new_target.new_full((), ident))
        send = torch.where(part.send_mask, picked, torch.gather(
            slot_ident, 1, slots).reshape(H, P, k))
        recv = shards.all_to_all(send)
        rid = part.recv_id.reshape(H, P * k).long()
        rtags = torch.gather(tags, 1, rid.clamp(max=ln - 1)).reshape(-1)
        ghost = slot_ident[:, block:]
    else:
        send = torch.where(part.send_mask, picked,
                           new_target.new_full((), ident))
        wire, ef_buf = _encode(codec, send.reshape(H * P, k),
                               ef_buf.reshape(H * P, k), ident)
        ef_buf = ef_buf.reshape(H, P, k)
        # the all-to-all: row (p, o) of the sender becomes row (o, p)
        wire = {key: shards.all_to_all(a.reshape(H, P, -1)).reshape(
            H * P, -1) for key, a in wire.items()}
        if payload is not None:  # the receiver's scalar, one per row
            payload = torch.as_tensor(payload).to(
                new_target.device).repeat_interleave(P)[:, None]
        recv = _decode(codec, wire, ident, new_target.dtype, payload)
        rtags = None
        ghost = new_target.new_full((H, ln - block), ident)
    # owned blocks flattened: held shard h's owner-local id i is h * block + i
    dest = (torch.arange(H, device=new_target.device)[:, None, None] * block
            + part.recv_id)
    owned = _scatter(new_target[:, :block].reshape(-1), dest.reshape(-1),
                     recv.reshape(-1), part.recv_mask.reshape(-1), op,
                     rtags)
    return torch.cat([owned.reshape(H, block), ghost], 1), ef_buf


# -- partition-aware apps -----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartitionedApp:
    """A ``FrontierApp`` restated over one shard's local node space.

    * ``app`` -- the per-shard app (BFS/SSSP reuse the single-device
      candidate and update verbatim: ghost entries sit at the merge
      identity, so their update is a no-op);
    * ``codec`` -- what ``compress=True`` selects ("exact" = none, SSSP);
    * ``init(part, source)`` -- ``(state [H, ...], mask [H, local_nodes])``
      of the ``H`` shards ``part`` holds, on the partition's device;
    * ``payload(states)`` -- ``[H]`` scalars the ``flag`` codec rebuilds
      lanes from (BFS: ``depth + 1``), or None;
    * ``shared(states, graphs)`` -- ``{name: [H] partials}`` of entries
      every shard's ``update`` reads that sum over all shards (the
      reference's ``psum`` inside the update: PageRank's dangling leak); the
      pipeline sums each over every shard, from the pre-update states,
      before any shard updates; or None.
    """

    app: FrontierApp
    codec: str
    init: Callable[[GraphPartition, int], tuple[dict, torch.Tensor]]
    payload: Optional[Callable[[list], torch.Tensor]] = None
    shared: Optional[Callable[[list, list], dict]] = None


def _stacked_point_mask(part: GraphPartition, source: int):
    """bool[H, local_nodes] with only the owner-local bit of ``source`` (no
    bit unless ``part`` holds its owner), and ``(held row, local id)`` of
    ``source`` or None."""
    mask = torch.zeros((len(part.held), part.local_nodes), dtype=torch.bool,
                       device=part.device)
    owner = source // part.block
    if owner not in part.held:
        return mask, None
    at = (owner - part.first_shard, source - owner * part.block)
    mask[at] = True
    return mask, at


def partitioned_bfs_app(part: GraphPartition) -> PartitionedApp:
    from repro_torch.apps.bfs import BFS_APP, UNVISITED

    def init(part: GraphPartition, source: int):
        mask, at = _stacked_point_mask(part, source)
        label = torch.full(mask.shape, UNVISITED, dtype=torch.int32,
                           device=part.device)
        if at is not None:
            label[at] = 0
        return {"label": label,
                "depth": torch.zeros(len(part.held), dtype=torch.int32,
                                     device=part.device)}, mask

    return PartitionedApp(
        app=BFS_APP, codec="flag", init=init,
        payload=lambda states: torch.stack([s["depth"] for s in states]) + 1)


def partitioned_sssp_app(part: GraphPartition) -> PartitionedApp:
    from repro_torch.apps.sssp import SSSP_APP

    def init(part: GraphPartition, source: int):
        mask, at = _stacked_point_mask(part, source)
        dist = torch.full(mask.shape, float("inf"), dtype=torch.float32,
                          device=part.device)
        if at is not None:
            dist[at] = 0.0
        return {"dist": dist}, mask

    # f32 distances have no exact sub-word encoding; parity wins over bytes
    return PartitionedApp(app=SSSP_APP, codec="exact", init=init)


def _owned_real_mask(part: GraphPartition) -> torch.Tensor:
    """bool[H, local_nodes]: owned slots holding a real global vertex (not
    a ghost, not the last shard's padding rows)."""
    r = torch.arange(part.local_nodes, device=part.device)
    p = torch.arange(part.held.start, part.held.stop,
                     device=part.device)[:, None]
    return (r < part.block) & (p * part.block + r < part.n_nodes)


def partitioned_pagerank_app(part: GraphPartition, *, iters: int = 20,
                             damping: float = 0.85) -> PartitionedApp:
    """PR with a partition-aware update: the dangling leak and the base mass
    use the global vertex count, the leak summed over every shard (owned
    degrees are global degrees: a shard owns all its block's out-edges)."""
    n = part.n_nodes

    def init(part: GraphPartition, source: int):
        own = _owned_real_mask(part)
        state = {"rank": torch.where(own, 1.0 / n, 0.0).to(torch.float32),
                 "acc": torch.zeros(own.shape, dtype=torch.float32,
                                    device=part.device),
                 "it": torch.zeros(len(part.held), dtype=torch.int32,
                                   device=part.device),
                 "own": own}
        return state, own.clone()

    def candidate(state, graph: CSRGraph, ef):
        deg = graph.degrees().clamp(min=1).to(torch.float32)
        return (state["rank"] / deg)[ef.srcs.clamp(max=graph.n_nodes - 1)]

    def shared(states, graphs):
        return {"leak": torch.stack([
            torch.where(s["own"] & (g.degrees() == 0), s["rank"], 0.0).sum()
            for s, g in zip(states, graphs)])}

    def update(state, acc, graph: CSRGraph):
        own = state["own"]
        rank = torch.where(
            own, (1.0 - damping) / n + damping * (acc + state["leak"] / n),
            0.0).to(torch.float32)
        state = {"rank": rank, "acc": torch.zeros_like(acc),
                 "it": state["it"] + 1, "own": own}
        return state, own

    def no_init(graph, source):
        raise TypeError("partitioned app: use PartitionedApp.init")

    app = FrontierApp(
        name="pagerank_part", filter_op="add", target="acc", init=no_init,
        candidate=candidate, update=update,
        cond=lambda state, mask: state["it"] < iters,
        result=lambda state: state["rank"], atomic=True)
    return PartitionedApp(app=app, codec="int8_ef", init=init, shared=shared)


# -- the superstep ------------------------------------------------------------

def _unstack(state: dict, n_parts: int) -> list[dict]:
    return [{k: v[p] for k, v in state.items()} for p in range(n_parts)]


def _restack(states: list[dict]) -> dict:
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def partitioned_superstep(graphs: list, app: FrontierApp, states: list,
                          mask: torch.Tensor, *, e_cap: int, f_cap: int,
                          exchange=None, shared=None, **step_kw):
    """One superstep over the held shards: ``frontier_scatter`` per shard
    (its kernels launched per shard), ``exchange(stacked new targets,
    states)``, the ``shared`` cross-shard entries, then ``app.update`` per
    shard.

    Every shard runs every superstep, empty frontier or not, so per-shard
    counters (BFS's depth) stay in lockstep.  Nothing given is changed in
    place: a caller may rerun the same inputs at a larger rung.  Returns
    ``(states, mask [H, local_nodes], overflow 0-d bool)``.
    """
    targets, overflow = [], []
    for g, st, mk in zip(graphs, states, mask):
        tgt, *_, ovf = frontier_scatter(g, app, st, mk, e_cap=e_cap,
                                        f_cap=f_cap, **step_kw)
        targets.append(tgt)
        overflow.append(ovf)
    target = torch.stack(targets)
    if exchange is not None:
        target = exchange(target, states)
    extra = shared(states, graphs) if shared is not None else {}
    out_states, out_masks = [], []
    for g, st, tgt in zip(graphs, states, target):
        st, mk = app.update(dict(st, **extra), tgt, g)
        out_states.append(st)
        out_masks.append(mk)
    return out_states, torch.stack(out_masks), torch.stack(overflow).any()


def _predict(degrees: torch.Tensor, mask: torch.Tensor,
             shards=None) -> tuple[int, int]:
    """The largest shard's (degree sum, node count): the reference's
    ``pmax`` of each shard's working set (one ``all_reduce(MAX)`` over a
    group), one host read."""
    need = torch.where(mask, degrees, 0).sum(1, dtype=torch.int64)
    count = mask.sum(1, dtype=torch.int64)
    shards = shards or StackedShards(mask.shape[0])
    need, count = shards.max(torch.stack([need, count], 1)).tolist()
    return need, count


# -- the partitioned pipeline -------------------------------------------------

class PartitionedFrontierPipeline:
    """Bucketed frontier runtime over an edge-partitioned graph.

    One ``frontier_scatter`` per shard a superstep, the boundary exchange,
    then ``app.update`` per shard (which therefore sees exactly the values a
    single-device step would have scattered).  The rung is the smallest that
    holds the largest shard's working set (the reference's ``pmax``, no
    hysteresis); convergence is any shard's frontier, read on the host once
    a superstep with the overflow flag.  ``compress=True`` switches the
    exchange to the app's codec; ``compress=False`` is the exact path.

    ``mesh=None`` steps every shard in this process on ``device``
    (``None``: the card, raising without one).  A group mesh
    (``launch.mesh.make_graph_mesh(P, group=...)``, the reference's
    ``mesh=``) runs one shard per rank on the mesh's device: each rank of
    the group builds this pipeline over the same partition (whole, or its
    own :meth:`GraphPartition.shard`) and keeps its shard alone, and
    ``run`` and ``gather_result`` are collectives that every rank calls.
    ``kernels=False`` runs the kernels' plain versions (the reference's
    ``gather=``).
    """

    def __init__(
        self,
        part: GraphPartition,
        papp: PartitionedApp,
        *,
        mesh=None,
        device: str | torch.device | None = None,
        mode: str = "baseline",
        iru_config: Optional[IRUConfig] = None,
        capacity_policy: Optional[CapacityPolicy] = None,
        max_iters: Optional[int] = None,
        kernels: bool = True,
        ragged: bool = True,
        compress: bool = False,
    ):
        if mode not in ("baseline", "sort", "hash"):
            raise ValueError(f"mode must be baseline|sort|hash, got {mode!r}")
        if mesh is None:
            if len(part.held) != part.n_parts:
                raise ValueError(
                    f"the stacked pipeline needs every shard; this partition "
                    f"holds shards {list(part.held)} of {part.n_parts} (one "
                    f"shard a rank takes a group mesh)")
            self.device = resolve_device(device)
            self.shards = StackedShards(part.n_parts)
            self.part = part.to(self.device)
        else:
            if mesh.shape.get(AXIS) != part.n_parts:
                raise ValueError(
                    f"mesh axis {AXIS!r} has size {mesh.shape.get(AXIS)}, "
                    f"partition has {part.n_parts} shards")
            self.shards = group_shards(mesh, AXIS)
            self.device = mesh.devices[0]
            if device is not None and torch.device(device) != self.device:
                raise ValueError(f"device={device!r} against the mesh's "
                                 f"{self.device}")
            self.part = part.shard(self.shards.rank).to(self.device)
        self.mesh = mesh
        self.papp = papp
        self.mode = mode
        self.iru_config = None if mode == "baseline" else dataclasses.replace(
            iru_config or IRUConfig(), mode=mode,
            filter_op=papp.app.filter_op)
        self.kernels = kernels
        self.ragged = ragged
        self.compress = compress
        self.codec = papp.codec if compress else "exact"
        self.max_iters = part.n_nodes if max_iters is None else max_iters
        self.capacity_policy = capacity_policy or CapacityPolicy()
        # per-shard ladder over the LOCAL capacities: the top rung holds any
        # shard's whole edge set, so a dispatched rung never overflows
        self.buckets = self.capacity_policy.ladder(
            max(part.edge_cap, 1), part.local_nodes)
        self.graphs = [self.part.shard_graph(p) for p in self.part.held]
        self._degrees = torch.stack([g.degrees() for g in self.graphs])
        self.n_hops = 0
        self.supersteps = 0
        self._state = None
        self._ef = None

    def _exchange(self, target, states):
        """The boundary exchange; carries the error-feedback buffer."""
        payload = (None if self.papp.payload is None
                   else self.papp.payload(states))
        target, self._ef = _boundary_exchange(
            target, self._ef, part=self.part, op=self.papp.app.filter_op,
            codec=self.codec, payload=payload, shards=self.shards)
        return target

    def _shared(self, states, graphs):
        """The app's per-shard partials, each summed over every shard."""
        return {k: self.shards.sum(v)
                for k, v in self.papp.shared(states, graphs).items()}

    def run(self, source: int = 0) -> torch.Tensor:
        part = self.part
        state, mask = self.papp.init(part, source)
        states = _unstack(state, len(part.held))
        self._ef = torch.zeros((len(part.held), part.n_parts,
                                max(part.lane_cap, 1)),
                               dtype=torch.float32, device=self.device)
        # the geometry is every rank's, so every rank makes the same choice
        exchange = (self._exchange if part.n_parts > 1 and part.lane_cap > 0
                    else None)
        shared = None if self.papp.shared is None else self._shared
        self.supersteps = 0
        last_b = None
        it, cont = 0, True
        while cont and it < self.max_iters:
            b = (_host_bucket(self.buckets, *_predict(self._degrees, mask,
                                                      self.shards))
                 if len(self.buckets) > 1 else 0)
            if b != last_b:
                self.n_hops += 1
                last_b = b
            e_cap, f_cap = self.buckets[b]
            states, mask, ovf = partitioned_superstep(
                self.graphs, self.papp.app, states, mask, e_cap=e_cap,
                f_cap=f_cap, exchange=exchange, shared=shared,
                iru_config=self.iru_config, kernels=self.kernels,
                ragged=self.ragged)
            # any shard's frontier, any shard's overflow: one sum, one read
            cont, ovf = (self.shards.sum(torch.stack(
                [mask.any(), ovf]).long()[None]) > 0).tolist()
            if ovf:
                raise RuntimeError(
                    f"partitioned superstep overflowed bucket {b} "
                    f"{self.buckets[b]} -- dispatch predicted wrong")
            it += 1
        self.supersteps = it
        self._state = _restack(states)
        return self.gather_result(self._state)

    def gather_result(self, state=None) -> torch.Tensor:
        """The global ``[n_nodes]`` result from the held shards' state (over
        a group, an ``all_gather`` of every rank's owned rows)."""
        if state is None:
            state = self._state
        stacked = self.papp.app.result(state)  # [H, local_nodes]
        owned = self.shards.gather(stacked[:, :self.part.block])
        return owned.reshape(-1)[:self.part.n_nodes]

    # -- boundary-traffic accounting (static: the maps are frozen) ----------
    @property
    def payload_itemsize(self) -> int:
        return 4  # int32 depth / f32 dist / f32 mass

    def boundary_traffic(self) -> dict:
        """Cross-shard boundary bytes per superstep, raw and on the wire.

        Counts the lanes of the off-diagonal (shard, peer) rows; ``raw`` is
        what the exact codec ships, ``wire`` what the active codec ships.
        The exchange runs every superstep at full lane capacity.
        """
        p_n, k = self.part.n_parts, self.part.lane_cap
        rows = p_n * (p_n - 1)
        raw = rows * k * self.payload_itemsize
        wire = rows * _wire_bytes(self.codec, k, self.payload_itemsize)
        return {
            "codec": self.codec,
            "raw_bytes_per_superstep": raw,
            "wire_bytes_per_superstep": wire,
            "reduction": raw / wire if wire else 1.0,
            "supersteps": self.supersteps,
            "raw_bytes_total": raw * self.supersteps,
            "wire_bytes_total": wire * self.supersteps,
        }


# -- one-call wrappers (mirror apps.bfs_pipeline & co.) -----------------------

def _as_partition(graph, n_parts: Optional[int], device,
                  mesh) -> GraphPartition:
    """A partition of ``graph``; a graph is cut into ``n_parts`` shards
    (default: the group mesh's size, else 1) on the pipeline's device."""
    if isinstance(graph, PartitionedGraphView):
        return graph.part
    if isinstance(graph, GraphPartition):
        return graph
    if mesh is not None:
        n_parts = n_parts or mesh.shape.get(AXIS)
        device = device or mesh.devices[0]
    part = partition_csr(graph.to(resolve_device(device)), n_parts or 1)
    return part.part if isinstance(part, PartitionedGraphView) else part


def bfs_partitioned(graph, source: int = 0, *, n_parts: Optional[int] = None,
                    compress: bool = False, mesh=None,
                    device: str | torch.device | None = None,
                    **kw) -> torch.Tensor:
    """Partitioned BFS; bit-identical to ``apps.bfs_pipeline`` (also with
    ``compress=True``: the flag codec is exact)."""
    part = _as_partition(graph, n_parts, device, mesh)
    pipe = PartitionedFrontierPipeline(
        part, partitioned_bfs_app(part), compress=compress, mesh=mesh,
        device=device, **kw)
    return pipe.run(source)


def sssp_partitioned(graph, source: int = 0, *, n_parts: Optional[int] = None,
                     compress: bool = False, mesh=None,
                     device: str | torch.device | None = None,
                     **kw) -> torch.Tensor:
    """Partitioned SSSP; bit-identical to ``apps.sssp_pipeline`` (min is
    order-independent; the codec stays exact by design)."""
    part = _as_partition(graph, n_parts, device, mesh)
    pipe = PartitionedFrontierPipeline(
        part, partitioned_sssp_app(part), compress=compress, mesh=mesh,
        device=device, **kw)
    return pipe.run(source)


def pagerank_partitioned(graph, *, n_parts: Optional[int] = None,
                         iters: int = 20, damping: float = 0.85,
                         compress: bool = False, mesh=None,
                         device: str | torch.device | None = None,
                         **kw) -> torch.Tensor:
    """Partitioned push PageRank; allclose to ``apps.pagerank_pipeline``
    (f32 sums regroup across shards; int8 + error feedback with
    ``compress=True``)."""
    part = _as_partition(graph, n_parts, device, mesh)
    pipe = PartitionedFrontierPipeline(
        part, partitioned_pagerank_app(part, iters=iters, damping=damping),
        compress=compress, max_iters=iters, mesh=mesh, device=device, **kw)
    return pipe.run(0)

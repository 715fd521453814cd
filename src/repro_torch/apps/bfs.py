"""Push Breadth-First Search (paper Fig. 8 instrumentation).

Counterpart of ``repro.apps.bfs``.  The irregular access is the label
lookup ``label[edge_frontier[i]]``; ``"iru"`` mode reorders the edge
frontier with the IRU before the lookup (the same result, a better
coalesced index stream, recorded for the cost model).  Three realizations,
one semantics:

* ``bfs`` -- the host (numpy) parity oracle, one ``reorder_frontier`` round
  trip a level in ``"iru"`` mode: what the cost model replays;
* ``bfs_pipeline`` / ``BFS_APP`` -- the device path through
  ``core.pipeline.FrontierPipeline`` (min-merged depth scatter,
  changed-label frontier);
* ``bfs_jit`` -- the dense all-edges variant (no frontier expansion).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.apps.trace import TraceRecorder
from repro_torch.core.iru import IRUConfig, reorder_frontier
from repro_torch.core.pipeline import (CapacityPolicy, FrontierApp,
                                       FrontierPipeline)
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph

UNVISITED = np.iinfo(np.int32).max


def _expand(row_ptr: np.ndarray, col_idx: np.ndarray,
            frontier: np.ndarray) -> np.ndarray:
    """Edge frontier (destination indices) of a node frontier."""
    starts = row_ptr[frontier]
    counts = row_ptr[frontier + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int32)
    offs = np.repeat(starts, counts) + (
        np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts))
    return col_idx[offs]


def bfs(graph: CSRGraph, source: int = 0, *, mode: str = "baseline",
        iru_config: Optional[IRUConfig] = None,
        recorder: Optional[TraceRecorder] = None,
        device: str | torch.device | None = None) -> np.ndarray:
    """Host (numpy) push BFS; int32 hop distances (UNVISITED = inf).

    ``mode="iru"`` serves each level's edge frontier through
    ``reorder_frontier(config=iru_config)``, whose engine runs on
    ``device`` (the card when None; ``hash_ref`` stays on the host).
    """
    row_ptr = graph.row_ptr.cpu().numpy()
    col_idx = graph.col_idx.cpu().numpy()
    label = np.full(graph.n_nodes, UNVISITED, np.int32)
    label[source] = 0
    frontier = np.array([source], np.int32)
    depth = 0
    cfg = iru_config or IRUConfig()
    while frontier.size:
        depth += 1
        ef = _expand(row_ptr, col_idx, frontier)
        if ef.size == 0:
            break
        if mode == "iru":
            ef_served, _, _, active = reorder_frontier(ef, config=cfg,
                                                       device=device)
            if recorder is not None:
                recorder.processed(ef.size)
                recorder.access(ef_served, active, atomic=False)
        else:
            ef_served = ef
            if recorder is not None:
                recorder.access(ef_served, atomic=False)
        # label lookup (the irregular access), then visitation update
        unvisited = np.unique(ef_served[label[ef_served] == UNVISITED])
        label[unvisited] = depth
        frontier = unvisited.astype(np.int32)
    return label


def _bfs_init(graph: CSRGraph, source: int):
    n, dev = graph.n_nodes, graph.device
    label = torch.full((n,), UNVISITED, dtype=torch.int32, device=dev)
    label[source] = 0
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[source] = True
    return {"label": label,
            "depth": torch.zeros((), dtype=torch.int32, device=dev)}, mask


def _bfs_candidate(state, graph: CSRGraph, ef):
    return (state["depth"] + 1).expand(ef.dsts.shape)


def _bfs_update(state, new_label, graph: CSRGraph):
    mask = new_label < state["label"]
    return {"label": new_label, "depth": state["depth"] + 1}, mask


BFS_APP = FrontierApp(
    name="bfs",
    filter_op="min",          # duplicate dsts merge to one depth write
    target="label",
    init=_bfs_init,
    candidate=_bfs_candidate,
    update=_bfs_update,
    cond=lambda state, mask: mask.any(),
    result=lambda state: state["label"],
    atomic=False,             # the paper's BFS access is a label *load*
)


def bfs_pipeline(
    graph: CSRGraph,
    source: int = 0,
    *,
    mode: str = "baseline",
    iru_config: Optional[IRUConfig] = None,
    capacity_policy: Optional[CapacityPolicy] = None,
    recorder: Optional[TraceRecorder] = None,
    device: str | torch.device | None = None,
    **pipeline_kw,
) -> torch.Tensor:
    """BFS through ``FrontierPipeline``; int32 labels on the run's device.

    ``mode`` is the pipeline's reorder stage: ``"baseline"``, ``"sort"`` or
    ``"hash"`` (the paper's IRU hash, kernel B3 on the card).  With a
    ``recorder`` the run is ``run_instrumented``.
    """
    pipe = FrontierPipeline(graph, BFS_APP, mode=mode, iru_config=iru_config,
                            capacity_policy=capacity_policy, device=device,
                            **pipeline_kw)
    if recorder is not None:
        return pipe.run_instrumented(source, recorder=recorder)
    return pipe.run(source)


def bfs_jit(graph: CSRGraph, source: int = 0, *,
            max_iters: int | None = None,
            device: str | torch.device | None = None) -> torch.Tensor:
    """Dense-frontier BFS over all edges every level (fixed shapes).

    The reference compiles this as one ``lax.while_loop``; here nothing is
    compiled: a host loop of whole-edge-array torch ops on ``device`` (the
    card when None) that reads one ``.any()`` a level.
    """
    g = graph.to(resolve_device(device))
    n = g.n_nodes
    src = g.edge_sources().long()
    dst = g.col_idx.long()
    max_iters = n if max_iters is None else max_iters
    label = torch.full((n,), UNVISITED, dtype=torch.int32, device=g.device)
    label[source] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=g.device)
    frontier[source] = True
    depth = 0
    while depth < max_iters:
        active = frontier[src]
        cand = torch.where(active & (label[dst] == UNVISITED),
                           torch.tensor(depth + 1, dtype=torch.int32,
                                        device=g.device), UNVISITED)
        new_label = label.scatter_reduce(0, dst, cand, reduce="amin",
                                         include_self=True)
        frontier = new_label < label
        label = torch.minimum(label, new_label)
        depth += 1
        if not bool(frontier.any()):
            break
    return label

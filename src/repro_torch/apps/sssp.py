"""Single-Source Shortest Paths, workfront Bellman-Ford (paper Fig. 9).

Counterpart of ``repro.apps.sssp``.  The irregular access is
``atomicMin(&label[edge], weight)``; the IRU merges duplicate destinations
with min at insert time, so merged-out lanes never issue their atomic.
``sssp`` is the host (numpy) parity oracle, with the IRU's reorder in
``"iru"`` mode; ``SSSP_APP`` is the min-merged relaxation scatter with an
improved-distance frontier for ``core.pipeline.FrontierPipeline``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.apps.trace import TraceRecorder
from repro_torch.core.iru import IRUConfig, reorder_frontier
from repro_torch.core.pipeline import (CapacityPolicy, FrontierApp,
                                       FrontierPipeline)
from repro_torch.graphs.csr import CSRGraph

INF = np.float32(np.inf)


def _expand_offsets(row_ptr: np.ndarray, frontier: np.ndarray) -> np.ndarray:
    starts = row_ptr[frontier]
    counts = row_ptr[frontier + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    return np.repeat(starts, counts) + (
        np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts))


def sssp(graph: CSRGraph, source: int = 0, *, mode: str = "baseline",
         iru_config: Optional[IRUConfig] = None,
         recorder: Optional[TraceRecorder] = None, max_rounds: int = 10_000,
         device: str | torch.device | None = None) -> np.ndarray:
    """Host (numpy) workfront Bellman-Ford; float32 distances.

    ``mode="iru"`` reorders and min-merges each round's relaxations through
    ``reorder_frontier(config=iru_config)`` on ``device`` (the card when
    None; ``hash_ref`` stays on the host) and records the merged atomicMin
    stream.
    """
    row_ptr = graph.row_ptr.cpu().numpy()
    col_idx = graph.col_idx.cpu().numpy()
    weights = graph.weights.cpu().numpy().astype(np.float32)
    dist = np.full(graph.n_nodes, INF, np.float32)
    dist[source] = 0.0
    frontier = np.array([source], np.int32)
    cfg = iru_config or IRUConfig(filter_op="min")
    rounds = 0
    while frontier.size and rounds < max_rounds:
        rounds += 1
        offs = _expand_offsets(row_ptr, frontier)
        if offs.size == 0:
            break
        counts = row_ptr[frontier + 1] - row_ptr[frontier]
        srcs = np.repeat(frontier, counts)
        dsts = col_idx[offs]
        cand = dist[srcs] + weights[offs]
        if mode == "iru":
            sidx, scand, _, sact = reorder_frontier(dsts, cand, config=cfg,
                                                    device=device)
            if recorder is not None:
                recorder.processed(dsts.size)
                recorder.access(sidx, sact, atomic=True)  # merged atomicMin
            sidx, scand = sidx[sact], scand[sact]
        else:
            sidx, scand = dsts, cand
            if recorder is not None:
                recorder.access(sidx, atomic=True)
        # atomicMin relaxation; next frontier = nodes whose distance dropped
        old = dist.copy()
        np.minimum.at(dist, sidx, scand)
        frontier = np.unique(sidx[dist[sidx] < old[sidx]]).astype(np.int32)
    return dist


def _sssp_init(graph: CSRGraph, source: int):
    n, dev = graph.n_nodes, graph.device
    dist = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    dist[source] = 0.0
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[source] = True
    return {"dist": dist}, mask


def _sssp_candidate(state, graph: CSRGraph, ef):
    # relaxation candidate dist[src] + w; padding srcs (== n) are clamped in
    # range, as the reference's gather clamps them, and their lanes are
    # overwritten with +inf by the pipeline
    srcs = ef.srcs.clamp(max=graph.n_nodes - 1)
    return state["dist"][srcs] + ef.weights


def _sssp_update(state, new_dist, graph: CSRGraph):
    mask = new_dist < state["dist"]
    return {"dist": new_dist}, mask


SSSP_APP = FrontierApp(
    name="sssp",
    filter_op="min",          # the merged atomicMin datapath
    target="dist",
    init=_sssp_init,
    candidate=_sssp_candidate,
    update=_sssp_update,
    cond=lambda state, mask: mask.any(),
    result=lambda state: state["dist"],
    atomic=True,
    needs_weights=True,
)


def sssp_pipeline(
    graph: CSRGraph,
    source: int = 0,
    *,
    mode: str = "baseline",
    iru_config: Optional[IRUConfig] = None,
    capacity_policy: Optional[CapacityPolicy] = None,
    recorder: Optional[TraceRecorder] = None,
    max_rounds: int = 10_000,
    device: str | torch.device | None = None,
    **pipeline_kw,
) -> torch.Tensor:
    """Workfront Bellman-Ford through ``FrontierPipeline``.

    ``mode`` is the pipeline's reorder stage: ``"baseline"``, ``"sort"`` or
    ``"hash"`` (the paper's IRU hash, kernel B3 on the card).  With a
    ``recorder`` the run is ``run_instrumented``.
    """
    pipe = FrontierPipeline(graph, SSSP_APP, mode=mode, iru_config=iru_config,
                            capacity_policy=capacity_policy,
                            max_iters=max_rounds, device=device,
                            **pipeline_kw)
    if recorder is not None:
        return pipe.run_instrumented(source, recorder=recorder)
    return pipe.run(source)

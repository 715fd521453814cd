"""Push Breadth-First Search (paper Fig. 8).

Counterpart of ``repro.apps.bfs``: ``BFS_APP`` declares BFS to
``core.pipeline.FrontierPipeline`` (min-merged depth scatter, changed-label
frontier); ``bfs`` is a numpy copy of the reference's host oracle.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.iru import IRUConfig
from repro_torch.core.pipeline import (CapacityPolicy, FrontierApp,
                                       FrontierPipeline)
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


def bfs(graph: CSRGraph, source: int = 0) -> np.ndarray:
    """Host (numpy) push BFS; int32 hop distances (UNVISITED = inf)."""
    row_ptr = graph.row_ptr.cpu().numpy()
    col_idx = graph.col_idx.cpu().numpy()
    label = np.full(graph.n_nodes, UNVISITED, np.int32)
    label[source] = 0
    frontier = np.array([source], np.int32)
    depth = 0
    while frontier.size:
        depth += 1
        ef = _expand(row_ptr, col_idx, frontier)
        if ef.size == 0:
            break
        unvisited = np.unique(ef[label[ef] == UNVISITED])
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
)


def bfs_pipeline(
    graph: CSRGraph,
    source: int = 0,
    *,
    mode: str = "baseline",
    iru_config: Optional[IRUConfig] = None,
    capacity_policy: Optional[CapacityPolicy] = None,
    device: str | torch.device | None = None,
    **pipeline_kw,
) -> torch.Tensor:
    """BFS through ``FrontierPipeline``; int32 labels on the run's device.

    ``mode`` is the pipeline's reorder stage: ``"baseline"``, ``"sort"`` or
    ``"hash"`` (the paper's IRU hash, kernel B3 on the card).
    """
    pipe = FrontierPipeline(graph, BFS_APP, mode=mode, iru_config=iru_config,
                            capacity_policy=capacity_policy, device=device,
                            **pipeline_kw)
    return pipe.run(source)

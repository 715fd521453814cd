"""Push PageRank (paper Fig. 10).

Counterpart of ``repro.apps.pagerank``: ``pagerank_app`` pushes
``rank[src]/deg[src]`` along every edge each iteration through the merged
scatter-add; ``pagerank`` is a numpy copy of the reference's host oracle.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.iru import IRUConfig
from repro_torch.core.pipeline import (CapacityPolicy, FrontierApp,
                                       FrontierPipeline)
from repro_torch.graphs.csr import CSRGraph


def pagerank(graph: CSRGraph, *, iters: int = 20,
             damping: float = 0.85) -> np.ndarray:
    """Host (numpy) push PageRank; float32 ranks."""
    n = graph.n_nodes
    srcs = graph.edge_sources().cpu().numpy()
    dsts = graph.col_idx.cpu().numpy()
    degrees = graph.degrees().cpu().numpy()
    deg = np.maximum(degrees, 1).astype(np.float32)
    rank = np.full(n, 1.0 / n, np.float32)
    dangling = degrees == 0
    for _ in range(iters):
        contrib = (rank / deg)[srcs]
        acc = np.zeros(n, np.float32)
        np.add.at(acc, dsts, contrib)
        leak = rank[dangling].sum()
        rank = ((1.0 - damping) / n
                + damping * (acc + leak / n)).astype(np.float32)
    return rank


def pagerank_app(iters: int = 20, damping: float = 0.85) -> FrontierApp:
    """PR as a frontier app: the frontier is all nodes, convergence is the
    iteration budget, and the merged scatter-add accumulates contributions
    into a fresh per-iteration ``acc`` target."""

    def init(graph: CSRGraph, source: int):
        n, dev = graph.n_nodes, graph.device
        state = {"rank": torch.full((n,), 1.0 / n, dtype=torch.float32,
                                    device=dev),
                 "acc": torch.zeros(n, dtype=torch.float32, device=dev),
                 "it": torch.zeros((), dtype=torch.int32, device=dev)}
        return state, torch.ones(n, dtype=torch.bool, device=dev)

    def candidate(state, graph: CSRGraph, ef):
        deg = graph.degrees().clamp(min=1).to(torch.float32)
        # padding srcs (== n) clamp in range, as the reference's gather does
        return (state["rank"] / deg)[ef.srcs.clamp(max=graph.n_nodes - 1)]

    def update(state, acc, graph: CSRGraph):
        n = graph.n_nodes
        dangling = graph.degrees() == 0
        leak = torch.where(dangling, state["rank"], 0.0).sum()
        rank = ((1.0 - damping) / n
                + damping * (acc + leak / n)).to(torch.float32)
        state = {"rank": rank, "acc": torch.zeros_like(acc),
                 "it": state["it"] + 1}
        return state, torch.ones(n, dtype=torch.bool, device=acc.device)

    return FrontierApp(
        name="pagerank",
        filter_op="add",      # the merged atomicAdd datapath
        target="acc",
        init=init,
        candidate=candidate,
        update=update,
        cond=lambda state, mask: state["it"] < iters,
        result=lambda state: state["rank"],
    )


def pagerank_pipeline(
    graph: CSRGraph,
    *,
    iters: int = 20,
    damping: float = 0.85,
    mode: str = "baseline",
    iru_config: Optional[IRUConfig] = None,
    capacity_policy: Optional[CapacityPolicy] = None,
    device: str | torch.device | None = None,
    **pipeline_kw,
) -> torch.Tensor:
    """Push PageRank through ``FrontierPipeline`` (allclose to
    :func:`pagerank`: fp-add order differs).

    ``mode`` is the pipeline's reorder stage: ``"baseline"``, ``"sort"`` or
    ``"hash"`` (the paper's IRU hash, kernel B3 on the card).
    """
    pipe = FrontierPipeline(graph, pagerank_app(iters, damping), mode=mode,
                            iru_config=iru_config,
                            capacity_policy=capacity_policy, max_iters=iters,
                            device=device, **pipeline_kw)
    return pipe.run()

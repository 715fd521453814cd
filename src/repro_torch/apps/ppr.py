"""Personalized PageRank (PPR) as a frontier app.

Counterpart of ``repro.apps.ppr``.  The push datapath of
:mod:`repro_torch.apps.pagerank` (every edge pushes ``rank[src]/deg[src]``
into the merged scatter-add), but the teleport vector is the query's source
node: walks restart at the seed, and dangling mass returns to it, so each
iteration's total mass stays 1.  PPR is the per-user query kind of the
multi-tenant serving engine (``serve.graph_engine``).

``ppr_app`` declares the solo app (all-nodes frontier, iteration budget),
``ppr_pipeline`` drives it through ``FrontierPipeline``, and ``ppr`` is a
numpy copy of the reference's host oracle.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.iru import IRUConfig
from repro_torch.core.pipeline import (CapacityPolicy, FrontierApp,
                                       FrontierPipeline)
from repro_torch.graphs.csr import CSRGraph


def ppr(graph: CSRGraph, source: int = 0, *, iters: int = 20,
        damping: float = 0.85) -> np.ndarray:
    """Host (numpy) PPR with sequential f32 accumulation; float32 ranks."""
    n = graph.n_nodes
    srcs = graph.edge_sources().cpu().numpy()
    dsts = graph.col_idx.cpu().numpy()
    degrees = graph.degrees().cpu().numpy()
    deg = np.maximum(degrees, 1).astype(np.float32)
    dangling = degrees == 0
    e_src = np.zeros(n, np.float32)
    e_src[source] = 1.0
    rank = e_src.copy()
    d = np.float32(damping)
    for _ in range(iters):
        contrib = (rank / deg)[srcs]
        acc = np.zeros(n, np.float32)
        np.add.at(acc, dsts, contrib)
        leak = rank[dangling].sum(dtype=np.float32)
        rank = ((1 - d) * e_src + d * acc + d * leak * e_src).astype(
            np.float32)
    return rank


def ppr_app(iters: int = 20, damping: float = 0.85) -> FrontierApp:
    """PPR as a frontier app: all-nodes frontier, iteration-budget
    convergence, seed-personalized teleport and dangling restart."""

    def init(graph: CSRGraph, source: int):
        n, dev = graph.n_nodes, graph.device
        e_src = torch.zeros(n, dtype=torch.float32, device=dev)
        e_src[source] = 1.0
        state = {"rank": e_src, "src": e_src.clone(),
                 "acc": torch.zeros(n, dtype=torch.float64, device=dev),
                 "it": torch.zeros((), dtype=torch.int32, device=dev)}
        return state, torch.ones(n, dtype=torch.bool, device=dev)

    def candidate(state, graph: CSRGraph, ef):
        deg = graph.degrees().clamp(min=1).to(torch.float32)
        # padding srcs (== n) clamp in range, as the reference's gather does
        return (state["rank"] / deg)[ef.srcs.clamp(max=graph.n_nodes - 1)]

    def update(state, acc64, graph: CSRGraph):
        acc = acc64.to(torch.float32)
        dangling = graph.degrees() == 0
        leak = torch.where(dangling, state["rank"], 0.0).sum()
        d = torch.tensor(damping, dtype=torch.float32, device=acc.device)
        rank = (1 - d) * state["src"] + d * acc + d * leak * state["src"]
        state = {"rank": rank, "src": state["src"],
                 "acc": torch.zeros_like(acc64), "it": state["it"] + 1}
        return state, torch.ones_like(rank, dtype=torch.bool)

    return FrontierApp(
        name="ppr",
        filter_op="add",      # the merged atomicAdd datapath
        target="acc",
        init=init,
        candidate=candidate,
        update=update,
        cond=lambda state, mask: state["it"] < iters,
        result=lambda state: state["rank"],
    )


def ppr_pipeline(
    graph: CSRGraph,
    source: int = 0,
    *,
    iters: int = 20,
    damping: float = 0.85,
    mode: str = "baseline",
    iru_config: Optional[IRUConfig] = None,
    capacity_policy: Optional[CapacityPolicy] = None,
    device: str | torch.device | None = None,
    **pipeline_kw,
) -> torch.Tensor:
    """PPR through ``FrontierPipeline`` (the solo run the serving engine's
    results are held against).  ``mode``: ``"baseline"``, ``"sort"`` or
    ``"hash"``."""
    pipe = FrontierPipeline(graph, ppr_app(iters, damping), mode=mode,
                            iru_config=iru_config,
                            capacity_policy=capacity_policy, max_iters=iters,
                            device=device, **pipeline_kw)
    return pipe.run(source)

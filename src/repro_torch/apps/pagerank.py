"""Push PageRank (paper Fig. 10 instrumentation).

Counterpart of ``repro.apps.pagerank``.  Each edge pushes
``rank[src]/deg[src]`` into ``atomicAdd(&acc[dst], w)``; the IRU merges
contributions to duplicate destinations with add while reordering, so the
surviving lanes carry pre-summed contributions.  ``pagerank`` is the
trace-collecting host implementation (parity oracle); ``pagerank_app``
declares PageRank to ``core.pipeline.FrontierPipeline`` (the all-nodes
frontier pushes every edge each iteration through the merged scatter-add);
``pagerank_jit`` is the dense whole-run variant on ``iru_scatter_add``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.apps.trace import TraceRecorder
from repro_torch.core.iru import IRUConfig, iru_scatter_add, reorder_frontier
from repro_torch.core.pipeline import (CapacityPolicy, FrontierApp,
                                       FrontierPipeline)
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph


def pagerank(graph: CSRGraph, *, iters: int = 20, damping: float = 0.85,
             mode: str = "baseline", iru_config: Optional[IRUConfig] = None,
             recorder: Optional[TraceRecorder] = None,
             device: str | torch.device | None = None) -> np.ndarray:
    """Host (numpy) push PageRank; float32 ranks.

    ``mode="iru"`` reorders and add-merges each iteration's contributions
    through ``reorder_frontier(config=iru_config)`` on ``device`` (the card
    when None; ``hash_ref`` stays on the host) and records the merged
    atomicAdd stream.
    """
    n = graph.n_nodes
    srcs = graph.edge_sources().cpu().numpy()
    dsts = graph.col_idx.cpu().numpy()
    degrees = graph.degrees().cpu().numpy()
    deg = np.maximum(degrees, 1).astype(np.float32)
    rank = np.full(n, 1.0 / n, np.float32)
    cfg = iru_config or IRUConfig(filter_op="add")
    dangling = degrees == 0
    for _ in range(iters):
        contrib = (rank / deg)[srcs]
        acc = np.zeros(n, np.float32)
        if mode == "iru":
            sidx, sval, _, sact = reorder_frontier(dsts, contrib, config=cfg,
                                                   device=device)
            if recorder is not None:
                recorder.processed(dsts.size)
                recorder.access(sidx, sact, atomic=True)
            np.add.at(acc, sidx[sact], sval[sact])
        else:
            if recorder is not None:
                recorder.access(dsts, atomic=True)
            np.add.at(acc, dsts, contrib)
        leak = rank[dangling].sum()
        rank = ((1.0 - damping) / n
                + damping * (acc + leak / n)).astype(np.float32)
    return rank


def pagerank_app(iters: int = 20, damping: float = 0.85) -> FrontierApp:
    """PR as a frontier app: the frontier is all nodes, convergence is the
    iteration budget, and the merged scatter-add accumulates contributions
    into a fresh per-iteration ``acc`` target.

    ``acc`` is float64, as the PPR apps' is: on the card the scatter's
    atomics add a hub's f32 contributions in a new order every run, and
    summed in float64 and rounded to f32 once (in ``update``) the ranks do
    not depend on that order; the reference's f32 accumulator is within
    the parity tests' tolerances of it."""

    def init(graph: CSRGraph, source: int):
        n, dev = graph.n_nodes, graph.device
        state = {"rank": torch.full((n,), 1.0 / n, dtype=torch.float32,
                                    device=dev),
                 "acc": torch.zeros(n, dtype=torch.float64, device=dev),
                 "it": torch.zeros((), dtype=torch.int32, device=dev)}
        return state, torch.ones(n, dtype=torch.bool, device=dev)

    def candidate(state, graph: CSRGraph, ef):
        deg = graph.degrees().clamp(min=1).to(torch.float32)
        # padding srcs (== n) clamp in range, as the reference's gather does
        return (state["rank"] / deg)[ef.srcs.clamp(max=graph.n_nodes - 1)]

    def update(state, acc64, graph: CSRGraph):
        n = graph.n_nodes
        acc = acc64.to(torch.float32)
        dangling = graph.degrees() == 0
        leak = torch.where(dangling, state["rank"], 0.0).sum()
        rank = ((1.0 - damping) / n
                + damping * (acc + leak / n)).to(torch.float32)
        state = {"rank": rank, "acc": torch.zeros_like(acc64),
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
        atomic=True,
    )


def pagerank_pipeline(
    graph: CSRGraph,
    *,
    iters: int = 20,
    damping: float = 0.85,
    mode: str = "baseline",
    iru_config: Optional[IRUConfig] = None,
    capacity_policy: Optional[CapacityPolicy] = None,
    recorder: Optional[TraceRecorder] = None,
    device: str | torch.device | None = None,
    **pipeline_kw,
) -> torch.Tensor:
    """Push PageRank through ``FrontierPipeline`` (allclose to
    :func:`pagerank`: fp-add order differs).

    ``mode`` is the pipeline's reorder stage: ``"baseline"``, ``"sort"`` or
    ``"hash"`` (the paper's IRU hash, kernel B3 on the card).  With a
    ``recorder`` the run is ``run_instrumented``.
    """
    pipe = FrontierPipeline(graph, pagerank_app(iters, damping), mode=mode,
                            iru_config=iru_config,
                            capacity_policy=capacity_policy, max_iters=iters,
                            device=device, **pipeline_kw)
    if recorder is not None:
        return pipe.run_instrumented(recorder=recorder)
    return pipe.run()


def pagerank_jit(src: torch.Tensor, dst: torch.Tensor, degrees: torch.Tensor,
                 n: int, *, iters: int = 20, damping: float = 0.85,
                 use_iru: bool = True,
                 device: str | torch.device | None = None) -> torch.Tensor:
    """Dense push PageRank over the edge arrays, ``iters`` iterations.

    The reference compiles this as one ``lax.scan``; here nothing is
    compiled: a host loop of whole-edge-array torch ops on ``device`` (the
    card when None).  With ``use_iru`` the scatter-add goes through
    ``core.iru.iru_scatter_add`` (the stable sort and kernel B2's merge on
    the card, then a duplicate-free scatter); without it, one
    ``index_add_``.
    """
    dev = resolve_device(device)
    src, dst, degrees = (x.to(dev) for x in (src, dst, degrees))
    deg = degrees.clamp(min=1).to(torch.float32)
    dangling = degrees == 0
    src_l, dst_l = src.long(), dst.long()
    rank = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    for _ in range(iters):
        contrib = (rank / deg)[src_l]
        zero = torch.zeros(n, dtype=torch.float32, device=dev)
        if use_iru:
            acc = iru_scatter_add(zero, dst, contrib)
        else:
            acc = zero.index_add_(0, dst_l, contrib)
        leak = torch.where(dangling, rank, 0.0).sum()
        rank = (1.0 - damping) / n + damping * (acc + leak / n)
    return rank

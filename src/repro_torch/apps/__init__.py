"""Graph applications of the paper (§4.1): push BFS, SSSP and PageRank, and
the serving stack's personalized PageRank, as ``FrontierApp`` records for
the pipeline, with numpy host oracles that record irregular-access traces
(``TraceRecorder``) for the cost model, and the dense whole-run variants."""
from repro_torch.apps.bfs import BFS_APP, bfs, bfs_jit, bfs_pipeline
from repro_torch.apps.pagerank import (pagerank, pagerank_app, pagerank_jit,
                                       pagerank_pipeline)
from repro_torch.apps.ppr import ppr, ppr_app, ppr_pipeline
from repro_torch.apps.sssp import SSSP_APP, sssp, sssp_pipeline
from repro_torch.apps.trace import TraceRecorder

__all__ = ["BFS_APP", "SSSP_APP", "TraceRecorder", "bfs", "bfs_jit",
           "bfs_pipeline", "pagerank", "pagerank_app", "pagerank_jit",
           "pagerank_pipeline", "ppr", "ppr_app", "ppr_pipeline", "sssp",
           "sssp_pipeline"]

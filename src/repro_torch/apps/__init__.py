"""Graph applications of the paper (§4.1): push BFS, SSSP and PageRank, and
the serving stack's personalized PageRank, as ``FrontierApp`` records for
the pipeline, with numpy host oracles."""
from repro_torch.apps.bfs import BFS_APP, bfs, bfs_pipeline
from repro_torch.apps.pagerank import pagerank, pagerank_app, pagerank_pipeline
from repro_torch.apps.ppr import ppr, ppr_app, ppr_pipeline
from repro_torch.apps.sssp import SSSP_APP, sssp, sssp_pipeline

__all__ = ["BFS_APP", "SSSP_APP", "bfs", "bfs_pipeline", "pagerank",
           "pagerank_app", "pagerank_pipeline", "ppr", "ppr_app", "ppr_pipeline",
           "sssp", "sssp_pipeline"]

"""Graph applications of the paper (§4.1): push BFS, SSSP and PageRank as
``FrontierApp`` records for the pipeline, with numpy host oracles."""
from repro_torch.apps.bfs import BFS_APP, bfs, bfs_pipeline
from repro_torch.apps.pagerank import pagerank, pagerank_app, pagerank_pipeline
from repro_torch.apps.sssp import SSSP_APP, sssp, sssp_pipeline

__all__ = ["BFS_APP", "SSSP_APP", "bfs", "bfs_pipeline", "pagerank",
           "pagerank_app", "pagerank_pipeline", "sssp", "sssp_pipeline"]

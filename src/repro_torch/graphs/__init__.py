from repro_torch.graphs.csr import (CSRGraph, EdgeFrontier, GraphView,
                                    expand_frontier, frontier_degree_sum,
                                    frontier_from_mask, from_edges, tile_csr)

__all__ = ["CSRGraph", "EdgeFrontier", "GraphView", "expand_frontier",
           "frontier_degree_sum", "frontier_from_mask", "from_edges",
           "tile_csr"]

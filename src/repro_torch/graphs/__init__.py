from repro_torch.graphs.csr import (CSRGraph, EdgeFrontier, expand_frontier,
                                    frontier_degree_sum, frontier_from_mask,
                                    from_edges)

__all__ = ["CSRGraph", "EdgeFrontier", "expand_frontier",
           "frontier_degree_sum", "frontier_from_mask", "from_edges"]

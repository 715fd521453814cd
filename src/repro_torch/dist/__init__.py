"""Distributed execution: the edge-partitioned frontier pipeline and its
boundary exchange (counterpart of ``repro.dist.graph_partition``) and the
int8-compressed collectives (``repro.dist.collectives``).  The shards run on
one card, stepped in turn by one process."""
from repro_torch.dist.collectives import allreduce_int8, compress_grads_int8_ef
from repro_torch.dist.graph_partition import (
    PartitionedApp, PartitionedFrontierPipeline, bfs_partitioned,
    dequantize_rows_i8, pagerank_partitioned, partitioned_bfs_app,
    partitioned_pagerank_app, partitioned_sssp_app, quantize_rows_i8,
    sssp_partitioned)

__all__ = ["PartitionedApp", "PartitionedFrontierPipeline",
           "allreduce_int8", "bfs_partitioned", "compress_grads_int8_ef",
           "dequantize_rows_i8", "pagerank_partitioned", "partitioned_bfs_app",
           "partitioned_pagerank_app", "partitioned_sssp_app",
           "quantize_rows_i8", "sssp_partitioned"]

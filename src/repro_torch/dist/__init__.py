"""Distributed execution: the edge-partitioned frontier pipeline and its
boundary exchange (counterpart of ``repro.dist.graph_partition``) and the
int8-compressed collectives (``repro.dist.collectives``).  The shards run
stacked on one device, stepped in turn by one process, or one a rank of a
``torch.distributed`` group (a group mesh).  ``dist.sharding`` (the
logical-axis rules and the ambient mesh, ``repro.dist.sharding``) is
imported by its own name.

The names below load their module on first use, so importing
``dist.sharding`` (as every model module does) loads nothing else."""
import importlib

_EXPORTS = {
    "allreduce_int8": "collectives", "compress_grads_int8_ef": "collectives",
    **{name: "graph_partition" for name in (
        "PartitionedApp", "PartitionedFrontierPipeline", "bfs_partitioned",
        "dequantize_rows_i8", "pagerank_partitioned", "partitioned_bfs_app",
        "partitioned_pagerank_app", "partitioned_sssp_app",
        "quantize_rows_i8", "sssp_partitioned")},
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)

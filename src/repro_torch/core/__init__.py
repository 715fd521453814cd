"""Core IRU library of the port: block geometry, filter/merge, the sort
engine and the frontier pipeline that composes them."""
from repro_torch.core.coalescing import BLOCK_BYTES, block_ids, elems_per_block
from repro_torch.core.filter import (compact, filter_rate, merge_sorted,
                                     run_starts, segment_ids)
from repro_torch.core.iru import (IRUConfig, IRUStream, iru_reorder,
                                  iru_scatter_add, iru_scatter_min,
                                  load_iru_gather, reorder_frontier)
from repro_torch.core.pipeline import (CapacityPolicy, FrontierApp,
                                       FrontierPipeline, StepResult,
                                       frontier_step)

__all__ = ["BLOCK_BYTES", "CapacityPolicy", "FrontierApp", "FrontierPipeline",
           "IRUConfig", "IRUStream", "StepResult", "block_ids", "compact",
           "elems_per_block", "filter_rate", "frontier_step", "iru_reorder",
           "iru_scatter_add", "iru_scatter_min", "load_iru_gather",
           "merge_sorted", "reorder_frontier", "run_starts", "segment_ids"]

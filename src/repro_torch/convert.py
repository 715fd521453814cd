"""Carry graphs, app state and model params across from the JAX package.

The tests run both packages on the same inputs: they hand the reference's
arrays over as numpy (``np.asarray(g.row_ptr)`` ...), and these helpers put
them on a torch device with the reference's dtypes.  The graph paths have
no weights; the models' random params, the LM's decode caches and
training states cross through :func:`params_from_numpy`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.csr import (CSRGraph, GraphPartition, GraphView,
                                    PartitionedGraphView)


def graph_from_numpy(row_ptr, col_idx, weights,
                     device: str | torch.device | None = None) -> CSRGraph:
    """CSR arrays (any array-like) -> :class:`CSRGraph` (int32/int32/f32)."""
    dev = resolve_device(device)
    return CSRGraph(
        row_ptr=torch.from_numpy(np.asarray(row_ptr, np.int32).copy()).to(dev),
        col_idx=torch.from_numpy(np.asarray(col_idx, np.int32).copy()).to(dev),
        weights=torch.from_numpy(
            np.asarray(weights, np.float32).copy()).to(dev))


def view_from_numpy(row_ptr, col_idx, weights, *, n_tenants: int,
                    base_nodes: int, base_edges: int,
                    device: str | torch.device | None = None) -> GraphView:
    """A tiled composite's arrays and tenant geometry -> :class:`GraphView`
    (what ``repro.graphs.csr.tile_csr`` returns, carried across)."""
    g = graph_from_numpy(row_ptr, col_idx, weights, device)
    return GraphView(g.row_ptr, g.col_idx, g.weights, n_tenants=n_tenants,
                     base_nodes=base_nodes, base_edges=base_edges)


def state_from_numpy(state: dict, device: str | torch.device | None = None
                     ) -> dict[str, torch.Tensor]:
    """App state dict of array-likes -> dict of tensors (dtypes kept;
    scalars become 0-d tensors)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(dev) for k, v in state.items()}


_PARTITION_GEOMETRY = ("n_nodes", "n_edges", "n_parts", "block", "ghost_cap",
                       "lane_cap", "edge_cap")


def partition_from_numpy(part, device: str | torch.device | None = None):
    """The reference's ``GraphPartition`` (its arrays as array-likes, its
    static geometry as ints) -> :class:`GraphPartition`; a reference
    ``PartitionedGraphView`` (``part`` and ``view``) ->
    :class:`PartitionedGraphView`.  Dtypes are kept."""
    dev = resolve_device(device)
    if hasattr(part, "view"):
        v = part.view
        return PartitionedGraphView(
            part=partition_from_numpy(part.part, dev),
            view=view_from_numpy(v.row_ptr, v.col_idx, v.weights,
                                 n_tenants=v.n_tenants,
                                 base_nodes=v.base_nodes,
                                 base_edges=v.base_edges, device=dev))
    tensors = {k: torch.from_numpy(np.array(getattr(part, k))).to(dev)
               for k in GraphPartition._TENSORS}
    return GraphPartition(**tensors, **{
        k: int(getattr(part, k)) for k in _PARTITION_GEOMETRY})


def _tensor_from_array(value, dev: torch.device) -> torch.Tensor:
    a = np.asarray(value)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def params_from_numpy(tree, device: str | torch.device | None = None):
    """Nested dicts, lists and tuples of array-likes (the reference's params,
    its decode cache -- a list per stage of tuples of dicts -- or a whole
    ``TrainState`` with its int8 moment dicts and 0-d int32 ``step``) ->
    the same nesting of tensors, dtypes kept; bf16 crosses bit for bit."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dev) for v in tree)
    return _tensor_from_array(tree, dev)

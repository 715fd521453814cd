"""Bandwidth-reduction collectives: int8 compression with error feedback,
and the two ways the port's shards talk to each other.

Counterpart of ``repro.dist.collectives``.  Compression reuses the blockwise
int8 quantizer (``optim.adamw.quantize_i8``): the payload is int8 plus one
f32 scale per 128-block (about 1.03 bytes an element instead of 4).

The reference runs one shard per device under ``shard_map`` and talks with
``all_to_all``, ``psum`` and ``pmax``.  The port has two layouts of its
shards, each with those three operations:

* :class:`StackedShards` -- every shard in this process on one device,
  stacked ``[P, ...]``: the all-to-all is a transpose, a reduction runs over
  the shard axis;
* :class:`RankShards` -- one shard per rank of a ``torch.distributed``
  process group (a group mesh, ``launch.mesh``): ``all_to_all_single``,
  ``all_reduce`` and ``all_gather``.

Code written over "the shards held here" (``held``: all of them, or this
rank's) runs unchanged in either.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import dequantize_i8, quantize_i8


class StackedShards:
    """All ``n_shards`` shards in this process, stacked on the leading dim."""

    def __init__(self, n_shards: int):
        self.n_shards = n_shards
        self.held = range(n_shards)

    def all_to_all(self, rows: torch.Tensor) -> torch.Tensor:
        """``rows[s, o]`` is what shard ``s`` sends shard ``o``; returns
        ``out[o, s]``, what shard ``o`` receives from ``s``."""
        return rows.transpose(0, 1)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of the held shards' ``x[s]`` (the reference's ``psum``)."""
        return x.sum(0)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(0)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's ``x[s]``, stacked ``[n_shards, ...]``."""
        return x


class RankShards:
    """One shard per rank of ``group``: this rank holds shard ``rank`` and
    every method is a collective that each rank of the group must call.

    Gloo takes CUDA tensors for ``all_to_all_single``, ``all_reduce`` and
    ``all_gather`` (int8, int32, int64 and f32, checked on an H100 with
    torch 2.11; gloo itself moves them through host memory), so nothing is
    staged here.  ``sent_bytes`` counts the bytes handed to
    ``all_to_all_single`` bound for another rank.
    """

    def __init__(self, group: dist.ProcessGroup):
        self.group = group
        self.rank = dist.get_rank(group)
        self.n_shards = dist.get_world_size(group)
        self.held = range(self.rank, self.rank + 1)
        self.sent_bytes = 0

    def all_to_all(self, rows: torch.Tensor) -> torch.Tensor:
        send = rows[0].contiguous()  # [n_shards, ...]: row o goes to rank o
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=self.group)
        self.sent_bytes += send.nbytes - send[self.rank].nbytes
        return out[None]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        y = x.sum(0)
        dist.all_reduce(y, group=self.group)
        return y

    def max(self, x: torch.Tensor) -> torch.Tensor:
        y = x.amax(0).contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(x[0]) for _ in range(self.n_shards)]
        dist.all_gather(parts, x[0].contiguous(), group=self.group)
        return torch.stack(parts)


def group_shards(mesh, axis: Optional[str] = None) -> RankShards:
    """The shards of a group mesh over ``axis`` (``launch.mesh``; ``None``:
    its one axis, a group mesh being 1-D).  Raises
    for a mesh without a process group (the stacked layout takes none), and
    when ``torch.distributed`` is not initialized: nothing drops to the
    stacked layout."""
    if mesh.group is None:
        raise ValueError(
            f"a {mesh.shape} mesh without a process group: the stacked "
            f"shards take no mesh, and one shard a rank takes a group mesh "
            f"(make_graph_mesh / make_iru_mesh with group=)")
    if axis is not None and axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no axis {axis!r}")
    if not dist.is_initialized():
        raise RuntimeError(
            "the mesh's process group is gone: torch.distributed is not "
            "initialized (init_process_group before the run, "
            "destroy_process_group after it)")
    return RankShards(mesh.group)


def _tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts with the same keys."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def compress_grads_int8_ef(grads: dict, ef: dict):
    """int8-compress a (nested) dict of gradients with error feedback.

    Returns ``(dequantized_grads, new_ef)`` where, per leaf and exactly in
    f32, ``dequantized + new_ef == grad + ef``: the residue is deferred to
    the next step, not lost.
    """
    deq = _tree_map(
        lambda g, e: dequantize_i8(quantize_i8(g.float() + e), g.shape),
        grads, ef)
    new_ef = _tree_map(lambda g, e, d: (g.float() + e) - d, grads, ef, deq)
    return deq, new_ef


def allreduce_int8(x: torch.Tensor, n_shards: Optional[int] = None, *,
                   mesh=None) -> torch.Tensor:
    """Sum ``x`` over its leading dim, with int8-compressed shard sums.

    Stacked (``n_shards``): ``x`` is ``[rows, ...]`` and shard ``i`` owns
    the ``i``-th of ``n_shards`` equal blocks of rows.  Over a group mesh
    (``mesh``, 1-D): ``x`` is this rank's block of rows.  Each
    shard's rows are summed exactly first (so one int8 payload a shard
    crosses the wire whatever its width), then quantized and dequantized;
    the result is the f32 sum of those over the shards (bounded per-block
    relative error), the reference's ``psum`` of the dequantized sums.
    """
    if (n_shards is None) == (mesh is None):
        raise TypeError("allreduce_int8 takes n_shards (stacked shards) or "
                        "a group mesh, not both")
    shards = (StackedShards(n_shards) if mesh is None
              else group_shards(mesh))
    held = len(shards.held)
    if x.shape[0] % held != 0:
        raise ValueError(
            f"allreduce_int8: leading dim of shape {tuple(x.shape)} does not "
            f"divide over {n_shards} shards; pad the leading dim to a "
            f"multiple of the shard count")
    local = x.reshape((held, -1) + tuple(x.shape[1:])).sum(1)
    deq = [dequantize_i8(quantize_i8(part), part.shape) for part in local]
    return shards.sum(torch.stack(deq))

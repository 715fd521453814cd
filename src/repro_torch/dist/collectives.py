"""Bandwidth-reduction collectives: int8 compression with error feedback.

Counterpart of ``repro.dist.collectives``.  Compression reuses the blockwise
int8 quantizer (``optim.adamw.quantize_i8``): the payload is int8 plus one
f32 scale per 128-block (about 1.03 bytes an element instead of 4).

The port runs every shard in one process on one device, as the partitioned
pipeline does: where the reference's ``shard_map`` gives each device one
block of rows and ``psum``s, :func:`allreduce_int8` takes the stacked
``[rows, ...]`` partials, sums each shard's block of rows exactly,
quantizes and dequantizes each shard's sum, and sums over the shards.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import dequantize_i8, quantize_i8


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


def allreduce_int8(x: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Sum ``x`` over its leading dim, with int8-compressed shard sums.

    ``x`` is ``[rows, ...]``; shard ``i`` owns the ``i``-th of
    ``n_shards`` equal blocks of rows.  Each shard's rows are summed exactly
    first (so one int8 payload a shard crosses the wire whatever its
    width), then quantized and dequantized; the result is the sum of those
    over the shards (bounded per-block relative error).
    """
    if x.shape[0] % n_shards != 0:
        raise ValueError(
            f"allreduce_int8: leading dim of shape {tuple(x.shape)} does not "
            f"divide over {n_shards} shards; pad the leading dim to a "
            f"multiple of the shard count")
    local = x.reshape((n_shards, -1) + tuple(x.shape[1:])).sum(1)
    deq = [dequantize_i8(quantize_i8(part), part.shape) for part in local]
    return torch.stack(deq).sum(0)

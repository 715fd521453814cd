"""Token embedding with the IRU lookup (counterpart of
``repro.models.embedding``; paper section 4.1 patterns).

Forward: a row gather over the vocab table -- an irregular access whose
index stream (token ids) has heavy duplication and no block locality.  With
``iru=True`` the stream is block-binned first (the BFS pattern, Fig. 8):
a stable sort, the gather in sorted order, then the inverse permutation.
The reference's gather is ``jnp.take``, and kernel B1's CUDA body takes
32-bit tables with one or two columns only, so this gather stays plain
torch (``index_select``).

Backward: scatter-add of per-token gradients with many duplicate
destinations -- the PageRank ``atomicAdd`` pattern (Fig. 10).  The IRU path
pre-merges duplicate token ids with fp-add (a segment sum over the sorted
stream) so each unique vocab row receives a single update; a
``torch.autograd.Function`` stands where the reference has a
``custom_vjp``.  Both paths give the same rows bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import filter as filt
from repro_torch.models.common import Initializer, constrain


def init_embedding(it: Initializer, vocab: int, d_model: int) -> None:
    it.weight("tok", (vocab, d_model), ("vocab", "embed"), scale=1.0)


def _sorted_gather(table: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Gather in block-binned order, then undo the permutation."""
    order = torch.sort(flat, stable=True).indices   # the IRU reorder (sort engine)
    rows = table.index_select(0, flat[order])       # binned irregular access
    inv = torch.argsort(order, stable=True)
    return rows.index_select(0, inv)


def _merged_scatter_add(vocab: int, flat: torch.Tensor,
                        g: torch.Tensor) -> torch.Tensor:
    """Duplicate-merged gradient scatter (PageRank pattern, Fig. 10)."""
    order = torch.sort(flat, stable=True).indices
    sidx = flat[order]
    sval = g.index_select(0, order)
    segs = filt.segment_ids(sidx)
    merged = torch.zeros_like(sval).index_add_(0, segs, sval)
    merged_lane = merged.index_select(0, segs)   # run total at every lane
    first = filt.run_starts(sidx)
    # one update per unique id (the run's first lane); the others go to a
    # sink row at ``vocab`` (the reference's mode="drop")
    dest = torch.where(first, sidx, vocab)
    out = g.new_zeros((vocab + 1, g.shape[-1]))
    return out.index_add_(0, dest, merged_lane)[:vocab]


class _IRUEmbed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, flat_tokens):
        ctx.save_for_backward(flat_tokens)
        ctx.vocab = table.shape[0]
        return _sorted_gather(table, flat_tokens)

    @staticmethod
    def backward(ctx, g):
        (flat_tokens,) = ctx.saved_tensors
        return _merged_scatter_add(ctx.vocab, flat_tokens, g), None


def embed(params: dict, tokens: torch.Tensor, *, iru: bool = True,
          scale: float | None = None) -> torch.Tensor:
    """tokens int[..., S] -> embeddings [..., S, D]."""
    table = params["tok"]
    shape = tokens.shape
    flat = tokens.reshape(-1).to(torch.int32)
    if iru:
        rows = _IRUEmbed.apply(table, flat)
    else:
        rows = table.index_select(0, flat)
    out = rows.reshape(*shape, table.shape[-1])
    if scale is not None:
        out = out * torch.tensor(scale, dtype=out.dtype, device=out.device)
    return constrain(out, ("batch", "seq", "embed"))


def logits(params: dict, x: torch.Tensor,
           head: torch.Tensor | None = None) -> torch.Tensor:
    """Project hidden states to (padded) vocab logits; tied when head is
    None.  The product runs in ``x``'s dtype and is cast to f32 after, as
    the reference's."""
    w = params["tok"].T if head is None else head
    out = torch.einsum("bsd,dv->bsv", x, w).float()
    return constrain(out, ("batch", "seq", "vocab"))

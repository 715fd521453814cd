"""Losses (counterpart of ``repro.train.losses``): causal LM cross-entropy
with z-loss, computed in f32."""
from __future__ import annotations

import torch


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, *,
                 z_loss: float = 1e-4,
                 vocab_real: int | None = None) -> torch.Tensor:
    """logits (B, S, Vpad), labels (B, S) int. Returns the scalar mean loss.

    ``vocab_real`` masks padded vocab columns out of the softmax (out of
    place: autograd needs the logits)."""
    lg = logits.float()
    if vocab_real is not None and vocab_real < lg.shape[-1]:
        pad = torch.arange(lg.shape[-1], device=lg.device) >= vocab_real
        lg = lg.masked_fill(pad, -1e30)
    lse = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, labels[..., None].long())[..., 0]
    loss = (lse - gold).mean()
    if z_loss:
        loss = loss + z_loss * lse.square().mean()
    return loss

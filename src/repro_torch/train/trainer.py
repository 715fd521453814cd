"""Training step factory (counterpart of ``repro.train.trainer``):
microbatched gradient accumulation and AdamW.

``make_train_step(cfg, pcfg, tc)`` returns ``train_step(state, batch) ->
(state, metrics)``:

* **Microbatching**: the global batch is split into ``pcfg.microbatches``
  slices run in turn; gradients accumulate in f32, and the loss, the aux
  loss and the MoE metrics are averaged over them, as the reference's
  ``mscan`` does.
* **Remat**: ``models.transformer`` honours ``pcfg.remat`` (each unit under
  ``torch.utils.checkpoint``).
* **Gradient compression**: optional int8 with error feedback
  (``dist.collectives.compress_grads_int8_ef``); off by default.

Gradients come from ``torch.autograd.grad`` over the parameter leaves,
which carry ``requires_grad``.  The update runs in place
(``optim.adamw.adamw_update``): the returned state holds the same tensors
as the one passed in.  Metrics are device tensors: the step reads nothing
on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.dist.collectives import compress_grads_int8_ef
from repro_torch.models import transformer as tfm
from repro_torch.models.measure import tree_leaves, tree_map
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.train.losses import softmax_xent


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adam: AdamWConfig = AdamWConfig()
    warmup_steps: int = 100
    total_steps: int = 10_000
    aux_weight: float = 1e-2     # MoE load-balance loss weight
    z_loss: float = 1e-4
    grad_compression: Optional[str] = None   # None | "int8_ef"


TrainState = dict  # {"params", "opt": {"m", "v", "step"}, "ef" (optional)}


def _with_opt(params: dict, tc: TrainConfig) -> TrainState:
    state: TrainState = {"params": params, "opt": adamw_init(params, tc.adam)}
    if tc.grad_compression == "int8_ef":
        state["ef"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state


def init_state(cfg: ModelConfig, pcfg: ParallelConfig, tc: TrainConfig,
               generator: Optional[torch.Generator],
               device: str | torch.device | None = None) -> TrainState:
    """Random params drawn from ``generator`` on ``device`` (``None``: the
    card), with ``requires_grad``, and zero optimizer state beside them."""
    params, _ = tfm.init_params(cfg, pcfg, generator, device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return _with_opt(params, tc)


def abstract_state(cfg: ModelConfig, pcfg: ParallelConfig, tc: TrainConfig):
    """(state tree on the ``meta`` device, the params' logical-axes tree):
    shapes and dtypes without allocation."""
    params, specs = tfm.abstract_params(cfg, pcfg)
    return _with_opt(params, tc), specs


def _split_batch(batch: dict, n: int) -> dict:
    """(B, ...) -> (n, B/n, ...) for the microbatch loop."""
    def f(x):
        B = x.shape[0]
        assert B % n == 0, (B, n)
        return x.reshape(n, B // n, *x.shape[1:])

    return {k: f(v) for k, v in batch.items()}


def _moe_metrics(stats) -> dict:
    """Reduce per-layer ``DispatchStats`` into flat metric tensors.

    ``stats`` is ``forward_train``'s list of stacked stats (leaves
    [rep, ...]); the result concatenates layers in stack order:
    ``moe_drop_rate`` f32[n_moe_layers] and ``moe_load_imbalance``
    (max / mean expert load) f32[n_moe_layers].
    """
    if not stats:
        return {}
    drop = torch.cat([s.drop_rate.reshape(-1) for s in stats]).float()

    def imb(s):
        load = s.expert_load.float()
        return (load.amax(dim=-1)
                / load.mean(dim=-1).clamp(min=1e-9)).reshape(-1)

    return {"moe_drop_rate": drop,
            "moe_load_imbalance": torch.cat([imb(s) for s in stats])}


def make_loss_fn(cfg: ModelConfig, pcfg: ParallelConfig,
                 tc: TrainConfig) -> Callable:
    """``loss_fn(params, mb) -> (total, (loss, aux, moe_metrics))``."""
    # the planned engine's stats ride the forward pass (its plan already
    # computes them); other engines log nothing
    collect = cfg.moe is not None and cfg.moe.dispatch == "iru_hash"

    def loss_fn(params, mb: dict):
        if collect:
            logits, aux, stats = tfm.forward_train(params, cfg, pcfg, mb,
                                                   return_stats=True)
            moem = _moe_metrics(stats)
        else:
            logits, aux = tfm.forward_train(params, cfg, pcfg, mb)
            moem = {}
        loss = softmax_xent(logits, mb["labels"], z_loss=tc.z_loss,
                            vocab_real=cfg.vocab_size)
        return loss + tc.aux_weight * aux, (loss, aux, moem)

    return loss_fn


def value_and_grad(loss_fn: Callable, params, mb: dict):
    """``((total, (loss, aux, moem)), grads)`` of ``loss_fn`` at ``params``
    (the reference's ``jax.value_and_grad(..., has_aux=True)``); grads
    have the params' tree and dtypes, zeros for an unused leaf."""
    leaves = tree_leaves(params)
    for p in leaves:  # a restored state's tensors come without it
        p.requires_grad_(True)
    with torch.enable_grad():
        total, (loss, aux, moem) = loss_fn(params, mb)
        gs = torch.autograd.grad(total, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, gs))
    grads = tree_map(lambda _: next(it), params)
    return ((total.detach(), (loss.detach(), aux.detach(),
                              tree_map(torch.Tensor.detach, moem))), grads)


def make_grad_fn(cfg: ModelConfig, pcfg: ParallelConfig,
                 tc: TrainConfig) -> Callable:
    """``grad_fn(params, batch) -> (grads, loss, aux, moe_metrics)`` over
    ``pcfg.microbatches`` microbatches: the train step's first half."""
    loss_fn = make_loss_fn(cfg, pcfg, tc)
    n_mb = max(pcfg.microbatches, 1)

    def grad_fn(params, batch: dict):
        if n_mb == 1:
            (_, (loss, aux, moem)), grads = value_and_grad(loss_fn, params,
                                                           batch)
            return grads, loss, aux, moem
        mbs = _split_batch(batch, n_mb)
        acc, lsum, asum, mstack = None, 0.0, 0.0, []
        for i in range(n_mb):
            (_, (l, a, mm)), g = value_and_grad(
                loss_fn, params, {k: v[i] for k, v in mbs.items()})
            if acc is None:  # 0 + g: the reference's zeros start, exactly
                acc = tree_map(lambda x: x.float().clone(), g)
            else:
                for s, x in zip(tree_leaves(acc), tree_leaves(g)):
                    s.add_(x)
            del g
            lsum, asum = lsum + l, asum + a
            mstack.append(mm)
        grads = tree_map(lambda x: x.div_(n_mb), acc)
        moem = {k: torch.stack([m[k] for m in mstack]).mean(dim=0)
                for k in mstack[0]}
        return grads, lsum / n_mb, asum / n_mb, moem

    return grad_fn


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                    tc: TrainConfig) -> Callable:
    grad_fn = make_grad_fn(cfg, pcfg, tc)

    def train_step(state: TrainState, batch: dict):
        params = state["params"]
        grads, loss, aux, moem = grad_fn(params, batch)
        if tc.grad_compression == "int8_ef":
            grads, new_ef = compress_grads_int8_ef(grads, state["ef"])
        # +1: the schedule is evaluated for the step being taken (a
        # 0-indexed ramp would zero the very first update)
        lr_scale = linear_warmup_cosine(state["opt"]["step"] + 1,
                                        tc.warmup_steps, tc.total_steps)
        new_params, new_opt = adamw_update(params, grads, state["opt"],
                                           tc.adam, lr_scale)
        new_state: TrainState = {"params": new_params, "opt": new_opt}
        if tc.grad_compression == "int8_ef":
            new_state["ef"] = new_ef
        metrics = {"loss": loss, "aux": aux, "grad_norm": global_norm(grads),
                   "lr_scale": lr_scale}
        metrics.update(moem)  # moe_drop_rate / moe_load_imbalance when MoE
        return new_state, metrics

    return train_step

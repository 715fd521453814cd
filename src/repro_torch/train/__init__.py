"""LM training (counterpart of ``repro.train``): the z-loss cross-entropy
and the train step with microbatches, remat and AdamW."""
from repro_torch.train.losses import softmax_xent
from repro_torch.train.trainer import (TrainConfig, TrainState,
                                       abstract_state, init_state,
                                       make_grad_fn, make_loss_fn,
                                       make_train_step)

__all__ = ["TrainConfig", "TrainState", "abstract_state", "init_state",
           "make_grad_fn", "make_loss_fn", "make_train_step", "softmax_xent"]

"""Model configuration descriptors (counterpart of ``repro.configs``).

Only :class:`MoEConfig` is ported so far: the MoE layer reads it.
``ModelConfig``, the registry and the architecture files come with the LM
substrate.
"""
from repro_torch.configs.base import MoEConfig

__all__ = ["MoEConfig"]

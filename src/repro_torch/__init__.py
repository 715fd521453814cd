"""PyTorch + CUDA port of the IRU frontier pipeline (``repro`` is the JAX
reference).

Subpackages mirror ``repro``'s names (``graphs.csr``, ``core.filter``,
``core.iru``, ``core.pipeline``, ``apps.bfs`` ...), so every module's
counterpart is obvious.  The port imports neither ``jax`` nor ``repro``.

Entry points (``FrontierPipeline`` and the ``*_pipeline`` wrappers) run on the
CUDA card unless the caller passes ``device="cpu"``; with no card and no
explicit device they raise (``device.resolve_device``).  The hand-written
Hopper kernels live under ``kernels/`` beside their plain PyTorch versions;
a wrapper launches its kernel for CUDA tensors and uses the plain version
only for CPU tensors.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

"""Shared helpers of the ``test_torch_*`` files (not collected itself).

Inputs are made with ``np.random.default_rng(seed)`` and handed to both
packages as numpy; nothing here touches process-global state.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda() -> torch.device:
    """The card, or a skip: a CUDA kernel has no CPU mode to test here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def t(x, device="cpu") -> torch.Tensor:
    """numpy / jax array -> torch tensor (dtype kept)."""
    return torch.from_numpy(np.array(x)).to(device)


def n(x) -> np.ndarray:
    """torch tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_graph_to_torch(g, device="cpu"):
    from repro_torch.convert import graph_from_numpy

    return graph_from_numpy(np.asarray(g.row_ptr), np.asarray(g.col_idx),
                            np.asarray(g.weights), device)


def offsets_stream(kind: str, v: int, length: int, rng) -> np.ndarray:
    """int32 gather offsets into a ``v``-row table."""
    if kind == "monotone":  # CSR offsets of an ascending frontier expansion
        return np.sort(rng.integers(0, v, length)).astype(np.int32)
    if kind == "runs":      # long runs of one offset (padding lanes)
        reps = -(-length // 4)
        return np.repeat(rng.integers(0, v, 4), reps)[:length].astype(np.int32)
    if kind == "strided":   # every third row: the groups meet the contract
        # but span three times the rows of contiguous offsets
        return (np.arange(length) * 3 % v).astype(np.int32)
    if kind == "sparse":    # a quarter of the nodes' CSR expansion: gappy
        cuts = np.sort(rng.choice(np.arange(1, v), min(v - 1, v // 30),
                                  replace=False)) if v > 1 else []
        bounds = np.concatenate(([0], cuts, [v]))
        pick = np.flatnonzero(rng.random(bounds.size - 1) < 0.25)
        off = np.concatenate([np.arange(bounds[i], bounds[i + 1])
                              for i in pick] + [np.zeros(1, np.int64)])
        return np.sort(np.resize(off, length)).astype(np.int32)
    return rng.integers(0, v, length).astype(np.int32)  # shuffled


def sorted_stream(length: int, n_distinct: int, rng,
                  long_run: int = 0) -> np.ndarray:
    """Sorted int32 index stream; ``long_run`` lanes share one hub index."""
    idx = rng.integers(0, n_distinct, length)
    if long_run:
        idx[:long_run] = n_distinct // 2
    return np.sort(idx).astype(np.int32)


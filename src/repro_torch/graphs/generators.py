"""Synthetic graphs: numpy copies of ``repro.graphs.generators``.

Bit-identical to the reference for the same seed (the same numpy calls in
the same order).  ``kron`` is the Graph500 R-MAT generator (a=.57 b=.19
c=.19 d=.05) and ``delaunay`` a triangulated lattice (degree about 6, high
diameter).  The ``*_edges`` forms return the raw edge list, so a caller can
attach its own weights before :func:`~repro_torch.graphs.csr.from_edges`
(which symmetrizes them with the edges).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.csr import CSRGraph, from_edges


def kron_edges(scale: int = 14, edge_factor: int = 8,
               seed: int = 4) -> tuple[np.ndarray, np.ndarray, int]:
    """Directed R-MAT edge list ``(src, dst, n)`` before symmetrize/dedup."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    a, b, c = 0.57, 0.19, 0.19
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for _ in range(scale):
        r = rng.random(m)
        s_bit = (r >= a + b).astype(np.int64)
        r2 = rng.random(m)
        d_bit = np.where(
            s_bit == 0, (r2 >= a / (a + b)).astype(np.int64),
            (r2 >= c / (1 - a - b)).astype(np.int64))
        src = (src << 1) | s_bit
        dst = (dst << 1) | d_bit
    perm = rng.permutation(n)  # kill degree-locality correlation
    return perm[src], perm[dst], n


def kron(scale: int = 14, edge_factor: int = 8, seed: int = 4, *,
         device: str | torch.device | None = None) -> CSRGraph:
    """Graph500 R-MAT (Kronecker) graph, symmetrized."""
    src, dst, n = kron_edges(scale, edge_factor, seed)
    return from_edges(src, dst, n, symmetrize=True, device=device)


def delaunay_edges(scale: int = 128) -> tuple[np.ndarray, np.ndarray, int]:
    """Triangulated ``scale x scale`` lattice edge list ``(src, dst, n)``."""
    n_side = scale
    n = n_side * n_side
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    nid = (ii * n_side + jj).ravel()
    right = nid[(jj < n_side - 1).ravel()]
    down = nid[(ii < n_side - 1).ravel()]
    diag = nid[((ii < n_side - 1) & (jj < n_side - 1)).ravel()]
    src = np.concatenate([right, down, diag])
    dst = np.concatenate([right + 1, down + n_side, diag + n_side + 1])
    return src, dst, n


def delaunay(scale: int = 128, *,
             device: str | torch.device | None = None) -> CSRGraph:
    """Triangulated lattice (degree about 6, planar-local).  The reference's
    ``seed`` argument is dropped: the lattice has no random part."""
    src, dst, n = delaunay_edges(scale)
    return from_edges(src, dst, n, symmetrize=True, device=device)

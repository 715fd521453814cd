"""Synthetic datasets of the paper's Table 3: numpy copies of
``repro.graphs.generators``.

Bit-identical to the reference for the same arguments (the same numpy calls
in the same order).  Each family imitates the block locality of one of the
paper's graphs, which governs the edge-frontier index stream:

  ca       -- road network: near-planar lattice, low degree, high diameter
  cond     -- collaboration: small-world clusters + random rewiring
  delaunay -- triangulation: lattice, degree about 6, local
  human    -- gene regulatory: extremely dense hubs (avg degree >> 100)
  kron     -- Graph500 R-MAT: heavy power-law (a=.57 b=.19 c=.19 d=.05)
  msdoor   -- FEM mesh: 3-D stencil neighbourhoods, banded locality

The ``*_edges`` forms return the raw edge list, so a caller can attach its
own weights before :func:`~repro_torch.graphs.csr.from_edges` (which
symmetrizes them with the edges).  Every generator takes ``device=`` (the
card when None).
"""
from __future__ import annotations

from typing import Callable

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


def _grid_road(n_side: int,
               seed: int = 0) -> tuple[np.ndarray, np.ndarray, int]:
    """2-D lattice with ~10% random shortcuts -- California-road-like."""
    rng = np.random.default_rng(seed)
    n = n_side * n_side
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    nid = (ii * n_side + jj).ravel()
    right = nid[(jj < n_side - 1).ravel()]
    down = nid[(ii < n_side - 1).ravel()]
    src = np.concatenate([right, down])
    dst = np.concatenate([right + 1, down + n_side])
    k = max(n // 10, 1)
    src = np.concatenate([src, rng.integers(0, n, k)])
    dst = np.concatenate([dst, rng.integers(0, n, k)])
    return src, dst, n


def ca(scale: int = 128, seed: int = 0, *,
       device: str | torch.device | None = None) -> CSRGraph:
    src, dst, n = _grid_road(scale, seed)
    return from_edges(src, dst, n, symmetrize=True, device=device)


def cond(n: int = 16_000, seed: int = 1, *,
         device: str | torch.device | None = None) -> CSRGraph:
    """Watts-Strogatz-ish collaboration network: ring of cliques + rewiring."""
    rng = np.random.default_rng(seed)
    k = 8
    base = np.arange(n)
    src = np.repeat(base, k)
    dst = (src + np.tile(np.arange(1, k + 1), n)) % n
    rewire = rng.random(src.shape[0]) < 0.1
    dst = np.where(rewire, rng.integers(0, n, src.shape[0]), dst)
    return from_edges(src, dst, n, symmetrize=True, device=device)


def human(n: int = 4_000, seed: int = 3, *,
          device: str | torch.device | None = None) -> CSRGraph:
    """Gene-regulatory-like: a few dominating hubs with huge degree."""
    rng = np.random.default_rng(seed)
    n_hubs = max(n // 100, 4)
    hubs = rng.choice(n, n_hubs, replace=False)
    m = n * 60  # very dense: avg degree ~ 120 after symmetrize
    src = rng.choice(hubs, m)
    dst = rng.integers(0, n, m)
    return from_edges(src, dst, n, symmetrize=True, device=device)


def msdoor(scale: int = 24, seed: int = 5, *,
           device: str | torch.device | None = None) -> CSRGraph:
    """3-D FEM-style mesh: 3x3x3 stencil neighbourhoods (high, banded
    degree).  ``seed`` is unused, as in the reference: the mesh has no
    random part."""
    s = scale
    n = s ** 3
    idx = np.arange(n)
    x, y, z = idx // (s * s), (idx // s) % s, idx % s
    src_l, dst_l = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if dx == dy == dz == 0:
                    continue
                nx, ny, nz = x + dx, y + dy, z + dz
                ok = ((nx >= 0) & (nx < s) & (ny >= 0) & (ny < s) & (nz >= 0)
                      & (nz < s))
                src_l.append(idx[ok])
                dst_l.append((nx * s * s + ny * s + nz)[ok])
    return from_edges(np.concatenate(src_l), np.concatenate(dst_l), n,
                      device=device)


DATASETS: dict[str, Callable[..., CSRGraph]] = {
    "ca": ca,
    "cond": cond,
    "delaunay": delaunay,
    "human": human,
    "kron": kron,
    "msdoor": msdoor,
}


def make_dataset(name: str, *, device: str | torch.device | None = None,
                 **kw) -> CSRGraph:
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    return DATASETS[name](device=device, **kw)

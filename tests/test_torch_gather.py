"""Port parity: kernel B1 (block-reuse gather) and its plain version.

A gather is exact, so every comparison is exact equality: the plain version
against ``repro``'s ``coalesced_gather_ref`` and ``window_contract_ok``.  The
CUDA kernel is held against the plain version in ``test_torch_kernels.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.coalesced_gather.coalesced_gather import (
    window_contract_ok as jax_window_contract_ok)
from repro.kernels.coalesced_gather.ref import coalesced_gather_ref as jax_ref
from repro_torch.kernels import launch_counts
from repro_torch.kernels.coalesced_gather import ops
from repro_torch.kernels.coalesced_gather.ref import (coalesced_gather_ref,
                                                      window_contract_ok)
from torch_parity import n, offsets_stream as _stream, t


def _table(v: int, d: int, dtype, rng) -> np.ndarray:
    if dtype == "int32":
        return rng.integers(-2**31, 2**31 - 1, (v, d)).astype(np.int32)
    return rng.standard_normal((v, d)).astype(np.float32)


@pytest.mark.parametrize("kind", ["monotone", "runs", "shuffled"])
@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_plain_gather_matches_reference(kind, d, dtype):
    rng = np.random.default_rng(0)
    table = _table(3000, d, dtype, rng)
    idx = _stream(kind, 3000, 1001, rng)
    want = np.asarray(jax_ref(jnp.asarray(table), jnp.asarray(idx)))
    got = ops.coalesced_gather(t(table), t(idx))
    assert np.array_equal(want, n(got))
    assert np.array_equal(want, n(coalesced_gather_ref(t(table), t(idx))))


def test_plain_csr_edge_gather_matches_take():
    rng = np.random.default_rng(1)
    col = rng.integers(0, 500, 2000).astype(np.int32)
    w = rng.uniform(1, 64, 2000).astype(np.float32)
    off = _stream("monotone", 2000, 777, rng)
    d1 = ops.csr_edge_gather(t(col), t(off))
    d2, w2 = ops.csr_edge_gather(t(col), t(off), t(w))
    assert np.array_equal(n(d1), col[off]) and np.array_equal(n(d2), col[off])
    assert np.array_equal(n(w2), w[off])


@pytest.mark.parametrize("kind", ["monotone", "runs", "shuffled"])
@pytest.mark.parametrize("group,window,length", [
    (8, 128, 1001), (8, 128, 1), (8, 16, 64), (256, 256, 5000),
    (4, 8, 203)])
def test_window_contract_matches_reference(kind, group, window, length):
    rng = np.random.default_rng(group * 7 + length)
    idx = _stream(kind, 4 * window * 10, length, rng)
    want = bool(jax_window_contract_ok(jnp.asarray(idx), group=group,
                                       window=window))
    assert bool(window_contract_ok(t(idx), group=group,
                                   window=window)) == want


def test_plain_path_never_counts_a_launch():
    before = launch_counts["coalesced_gather"]
    ops.coalesced_gather(torch.zeros(10, 1), torch.arange(5, dtype=torch.int32))
    assert launch_counts["coalesced_gather"] == before

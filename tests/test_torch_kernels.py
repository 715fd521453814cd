"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a card (a CUDA kernel has
no CPU mode).  The file imports neither ``jax`` nor ``repro``, so it also
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py

Tolerances: the gather is exact; segment-merge survivor masks and ``min`` /
``max`` payloads are exact; float ``add`` payloads are held to rtol 1e-5
(+ atol 1e-6 near zero), because the kernel's scans add in another order than
the plain scatter reduction.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import filter as filt
from repro_torch.kernels import launch_counts
from repro_torch.kernels.coalesced_gather import ops as gather_ops
from repro_torch.kernels.coalesced_gather.ref import coalesced_gather_ref
from repro_torch.kernels.segment_merge import ops as merge_ops
from repro_torch.kernels.segment_merge.ref import segment_merge_ref
from torch_parity import cuda  # noqa: F401  (a fixture)
from torch_parity import offsets_stream as _stream
from torch_parity import sorted_stream as _sorted_stream
from torch_parity import t

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("group,window", [(8, 128), (256, 256), (3, 5)])
@pytest.mark.parametrize("v", [7, 200, 70_000])
@pytest.mark.parametrize("kind", ["monotone", "runs", "shuffled"])
@pytest.mark.parametrize("d", [1, 2])
def test_gather_matches_plain(cuda, group, window, v, kind, d):
    rng = np.random.default_rng(v + group)
    table = t(rng.standard_normal((v, d)).astype(np.float32), cuda)
    idx = t(_stream(kind, v, 9999, rng), cuda)
    before = launch_counts["coalesced_gather"]
    got = gather_ops.coalesced_gather(table, idx, group=group, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, coalesced_gather_ref(table, idx))
    assert launch_counts["coalesced_gather"] == before + 1


def test_csr_edge_gather_matches_plain(cuda):
    rng = np.random.default_rng(4)
    col = t(rng.integers(0, 10**6, 300_000).astype(np.int32), cuda)
    w = t(rng.uniform(1, 64, 300_000).astype(np.float32), cuda)
    off = t(_stream("monotone", 300_000, 123_457, rng), cuda)
    dsts, wts = gather_ops.csr_edge_gather(col, off, w)
    assert torch.equal(dsts, col[off.long()])
    assert torch.equal(wts, w[off.long()])
    assert torch.equal(gather_ops.csr_edge_gather(col, off), col[off.long()])


def test_gather_rejects_bad_inputs(cuda):
    table = torch.zeros(10, 3, device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        gather_ops.coalesced_gather(table, idx)          # D = 3
    with pytest.raises(ValueError):
        gather_ops.coalesced_gather(table[:, :1].contiguous(), idx.long())
    with pytest.raises(ValueError):
        gather_ops.coalesced_gather(table[:, :1].cpu(), idx)


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("length,long_run", [(1, 0), (1023, 0), (1025, 0),
                                             (70_000, 5000),
                                             (300_000, 150_000)])
@pytest.mark.parametrize("live", [None, 0, "half", "all"])
def test_segment_merge_matches_plain(cuda, op, dtype, length, long_run, live):
    rng = np.random.default_rng(length)
    idx = t(_sorted_stream(length, max(length // 8, 2), rng, long_run), cuda)
    if dtype == "int32":
        vals = t(rng.integers(-1000, 1000, length).astype(np.int32), cuda)
    else:
        vals = t(rng.standard_normal(length).astype(np.float32), cuda)
    active = None if live is None else torch.arange(
        length, device=cuda) < {0: 0, "half": length // 2,
                                "all": length}[live]
    got_v, got_s = merge_ops.segment_merge(idx, vals, op=op, active=active)
    want_v, want_s = segment_merge_ref(idx, vals, op, active)
    torch.cuda.synchronize()
    assert torch.equal(got_s, want_s)
    if op == "add" and dtype == "float32":
        torch.testing.assert_close(got_v, want_v, rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(got_v, want_v)


def test_segment_merge_rejects_bad_inputs(cuda):
    idx = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        merge_ops.segment_merge(idx, torch.zeros(8, 2, device=cuda))
    with pytest.raises(ValueError):
        merge_ops.segment_merge(idx.long(), torch.zeros(8, device=cuda))
    with pytest.raises(ValueError):
        merge_ops.segment_merge(idx, torch.zeros(8, device=cuda,
                                                 dtype=torch.float64))
    with pytest.raises(NotImplementedError):
        filt.merge_sorted(idx, torch.zeros(8, device=cuda), "tagged",
                          tags=torch.zeros(8, dtype=torch.bool, device=cuda))

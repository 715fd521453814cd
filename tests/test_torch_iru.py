"""Port parity: the sort engine of ``core.iru`` against ``repro.core.iru``.

Indices, positions and active flags are bit-identical (a stable sort and an
exact run structure).  Payloads are exact for ``min``/``max`` and for no
merge; merged ``add`` payloads are held to rtol 1e-5 (+ atol 1e-6 near
zero): fp addition order differs between XLA's segment sum and the
plain scatter reduction.
"""
from __future__ import annotations


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import iru as jiru
from repro_torch.core import iru
from torch_parity import n, t

N = 700


def _stream(rng, payload: str):
    idx = rng.integers(0, 120, N).astype(np.int32)
    idx[::7] = 120  # padding-style sentinel lanes mixed in
    if payload == "int32":
        sec = rng.integers(-500, 500, N).astype(np.int32)
    elif payload == "2d":
        sec = rng.standard_normal((N, 3)).astype(np.float32)
    else:
        sec = rng.standard_normal(N).astype(np.float32)
    return idx, sec


def _assert_streams(want, got, op):
    for field in ("indices", "positions", "active"):
        a, b = np.asarray(getattr(want, field)), n(getattr(got, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    ws, gs = np.asarray(want.secondary), n(got.secondary)
    assert ws.dtype == gs.dtype
    if op == "add" and ws.dtype == np.float32:
        # merged-out lanes carry their run's sum too, so every lane is a sum
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)
    else:
        assert np.array_equal(ws, gs)


@pytest.mark.parametrize("op", [None, "add", "min", "max"])
@pytest.mark.parametrize("live", [None, 0, 333, N])
@pytest.mark.parametrize("payload", ["float32", "int32", "2d"])
def test_sort_engine_matches_reference(op, live, payload):
    rng = np.random.default_rng(42)
    idx, sec = _stream(rng, payload)
    jcfg = jiru.IRUConfig(mode="sort", filter_op=op)
    tcfg = iru.IRUConfig(mode="sort", filter_op=op)
    want = jiru.iru_reorder(jnp.asarray(idx), jnp.asarray(sec), config=jcfg,
                            n_live=None if live is None else jnp.int32(live))
    got = iru.iru_reorder(t(idx), t(sec), config=tcfg,
                          n_live=None if live is None
                          else torch.tensor(live, dtype=torch.int32))
    _assert_streams(want, got, op)


@pytest.mark.parametrize("op", ["add", "min"])
def test_sort_engine_without_compaction(op):
    rng = np.random.default_rng(8)
    idx, sec = _stream(rng, "float32")
    jcfg = jiru.IRUConfig(mode="sort", filter_op=op, compact=False)
    tcfg = iru.IRUConfig(mode="sort", filter_op=op, compact=False)
    want = jiru.iru_reorder(jnp.asarray(idx), jnp.asarray(sec), config=jcfg,
                            n_live=jnp.int32(500))
    got = iru.iru_reorder(t(idx), t(sec), config=tcfg, n_live=500)
    _assert_streams(want, got, op)


def test_default_secondary_and_plain_merge_option():
    rng = np.random.default_rng(1)
    idx, _ = _stream(rng, "float32")
    want = jiru.iru_reorder(jnp.asarray(idx))
    got = iru.iru_reorder(t(idx))
    _assert_streams(want, got, None)
    cfg = iru.IRUConfig(filter_op="min")
    a = iru.iru_reorder(t(idx), t(idx.astype(np.float32)), config=cfg)
    b = iru.iru_reorder(t(idx), t(idx.astype(np.float32)), config=cfg,
                        kernels=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("fn", ["iru_scatter_add", "iru_scatter_min"])
def test_merged_scatters_match_reference(fn):
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 50, 400).astype(np.int32)
    vals = rng.uniform(0, 4, 400).astype(np.float32)
    target = rng.uniform(0, 4, 50).astype(np.float32)
    want = getattr(jiru, fn)(jnp.asarray(target), jnp.asarray(idx),
                             jnp.asarray(vals))
    got = getattr(iru, fn)(t(target), t(idx), t(vals))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cfg", [
    dict(mode="hash"), dict(mode="hash_ref"), dict(window_elems=64)])
def test_later_slice_features_raise(cfg):
    with pytest.raises(NotImplementedError, match="next slice"):
        iru.iru_reorder(torch.arange(8, dtype=torch.int32),
                        config=iru.IRUConfig(**cfg))


def test_bad_secondary_shape_raises():
    with pytest.raises(ValueError, match="secondary"):
        iru.iru_reorder(torch.arange(8, dtype=torch.int32), torch.zeros(7))

"""Port parity: the engines of ``core.iru`` against ``repro.core.iru``.

The sort engine, the hash engine (its plain version on the CPU) and the
host oracle ``hash_ref``.  Indices, positions and active flags are
bit-identical (a stable sort, the hash's exact layout, an exact run
structure).  Payloads are exact for ``min``/``max`` and for no
merge; merged ``add`` payloads are held to rtol 1e-5 (+ atol 1e-6 near
zero): fp addition order differs between XLA's segment sum and the
plain scatter reduction.
"""
from __future__ import annotations

import dataclasses

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
    pytest.param(dict(window_elems=64), id="cfg2"),
    pytest.param(dict(mode="hash", window_elems=64), id="hash-window")])
def test_later_slice_features_raise(cfg):
    """Streaming windows, once refused here for a later slice, now run: the
    result is each 64-lane window reordered on its own, positions offset by
    the window's start (``tests/test_torch_streaming.py`` holds them against
    the reference)."""
    rng = np.random.default_rng(2)
    idx = t(rng.integers(0, 50, 150).astype(np.int32))
    got = iru.iru_reorder(idx, config=iru.IRUConfig(**cfg))
    whole = dataclasses.replace(iru.IRUConfig(**cfg), window_elems=None)
    for s0 in range(0, 150, 64):
        part = iru.iru_reorder(idx[s0:s0 + 64], config=whole)
        assert torch.equal(got.indices[s0:s0 + 64], part.indices)
        assert torch.equal(got.positions[s0:s0 + 64], part.positions + s0)


@pytest.mark.parametrize("op", [None, "add", "min", "max"])
@pytest.mark.parametrize("live", [None, 333])
@pytest.mark.parametrize("payload", ["float32", "2d"])
@pytest.mark.parametrize("mode", ["hash", "hash_ref"])
def test_hash_engines_match_reference(mode, payload, live, op):
    """The hash engine (its plain version here) and the host oracle."""
    rng = np.random.default_rng(11)
    idx, sec = _stream(rng, payload)
    jcfg = jiru.IRUConfig(mode=mode, filter_op=op)
    tcfg = iru.IRUConfig(mode=mode, filter_op=op)
    want = jiru.iru_reorder(jnp.asarray(idx), jnp.asarray(sec), config=jcfg,
                            n_live=None if live is None else jnp.int32(live))
    got = iru.iru_reorder(t(idx), t(sec), config=tcfg,
                          n_live=None if live is None
                          else torch.tensor(live, dtype=torch.int32))
    _assert_streams(want, got, op)


@pytest.mark.parametrize("mode", ["hash", "hash_ref"])
@pytest.mark.parametrize("live", [None, 600])
def test_hash_round_cap_and_geometry_match_reference(mode, live):
    rng = np.random.default_rng(12)
    idx, sec = _stream(rng, "float32")
    kw = dict(mode=mode, filter_op="add", num_sets=16, slots=4, round_cap=3,
              target_elem_bytes=8, block_bytes=64)
    want = jiru.iru_reorder(jnp.asarray(idx), jnp.asarray(sec),
                            config=jiru.IRUConfig(n_banks=1, **kw),
                            n_live=None if live is None else jnp.int32(live))
    got = iru.iru_reorder(t(idx), t(sec), config=iru.IRUConfig(**kw),
                          n_live=live)
    _assert_streams(want, got, "add")


@pytest.mark.parametrize("mode", ["sort", "hash"])
def test_tagged_merge_matches_reference(mode):
    rng = np.random.default_rng(13)
    idx, sec = _stream(rng, "float32")
    table = rng.random(122) < 0.5
    want = jiru.iru_reorder(jnp.asarray(idx), jnp.asarray(sec),
                            config=jiru.IRUConfig(mode=mode,
                                                  filter_op="tagged"),
                            n_live=jnp.int32(500),
                            tag_table=jnp.asarray(table))
    got = iru.iru_reorder(t(idx), t(sec),
                          config=iru.IRUConfig(mode=mode, filter_op="tagged"),
                          n_live=500, tag_table=t(table))
    _assert_streams(want, got, "add")


def test_tag_table_rules():
    idx = torch.arange(8, dtype=torch.int32)
    table = torch.zeros(10, dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="hash_ref"):
        iru.iru_reorder(idx, config=iru.IRUConfig(mode="hash_ref",
                                                  filter_op="tagged"),
                        tag_table=table)
    with pytest.raises(ValueError, match="tag_table"):
        iru.iru_reorder(idx, config=iru.IRUConfig(mode="hash",
                                                  filter_op="tagged"))
    with pytest.raises(ValueError, match="tag_table"):
        iru.iru_reorder(idx, config=iru.IRUConfig(mode="hash"),
                        tag_table=table)


@pytest.mark.parametrize("bad", [dict(round_cap=0), dict(num_sets=0),
                                 dict(slots=0), dict(num_sets=1023),
                                 dict(num_sets=30, n_partitions=4)])
def test_config_checks(bad):
    """As the reference: the default ``n_banks=2`` rejects an odd
    ``num_sets``, which must split evenly into partitions x banks."""
    with pytest.raises(ValueError):
        iru.IRUConfig(**bad)


def test_hash_engine_is_not_compacted():
    """The hash engines emit survivors at the front already, so ``compact``
    changes nothing there (it reorders the sort engine's output)."""
    rng = np.random.default_rng(14)
    idx, sec = _stream(rng, "float32")
    for mode in ("hash", "hash_ref"):
        a, b = (iru.iru_reorder(t(idx), t(sec), n_live=500,
                                config=iru.IRUConfig(mode=mode,
                                                     filter_op="min",
                                                     compact=c))
                for c in (True, False))
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        act = a.active.numpy()
        assert not act[int(act.sum()):].any()  # survivors lead


@pytest.mark.parametrize("fn", ["iru_scatter_add", "iru_scatter_min"])
@pytest.mark.parametrize("mode", ["hash", "hash_ref"])
def test_merged_scatters_hash_mode_match_reference(fn, mode):
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 50, 400).astype(np.int32)
    vals = rng.uniform(0, 4, 400).astype(np.float32)
    target = rng.uniform(0, 4, 50).astype(np.float32)
    want = getattr(jiru, fn)(jnp.asarray(target), jnp.asarray(idx),
                             jnp.asarray(vals),
                             config=jiru.IRUConfig(mode=mode))
    got = getattr(iru, fn)(t(target), t(idx), t(vals),
                           config=iru.IRUConfig(mode=mode))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_bad_secondary_shape_raises():
    with pytest.raises(ValueError, match="secondary"):
        iru.iru_reorder(torch.arange(8, dtype=torch.int32), torch.zeros(7))

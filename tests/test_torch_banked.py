"""Port parity: the banked hash engine (paper §3.2: sets striped over
partitions, each partition reordered on its own, partition-major emission)
and its oracle, against ``repro.kernels.iru_reorder.banked`` and
``repro.kernels.iru_reorder.ref``.

The port's plain ``hash_reorder_banked`` and its numpy
``ref.hash_reorder_ref_banked`` take the same seeded numpy inputs as the
reference's engine and oracle.  Indices, positions and active flags are
bit-identical; payloads are exact for ``min``, ``max`` and no merge, and
held to rtol 1e-5 (+ atol 1e-6 near zero) for ``add``, whose fp addition
order differs between XLA's scatter-add and the plain version's
``index_add_``.  The two oracles are bit-identical, payloads included.
The round-cap fallback (all-one-set, two hot sets, Zipf) and the capacity
bypass are driven on both sides, as ``tests/test_iru_banked.py`` drives the
reference.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import iru as jiru
from repro.kernels.iru_reorder import ref as jref
from repro.kernels.iru_reorder.banked import hash_reorder_banked as jbanked
from repro_torch.core import iru as tiru
from repro_torch.kernels.iru_reorder import ref as tref
from repro_torch.kernels.iru_reorder.banked import hash_reorder_banked
from torch_parity import n, t


def _same_set_indices(count, *, num_sets, target_set=3, epb=32):
    """``count`` distinct indices all hashing to one set."""
    out, block = [], 0
    while len(out) < count:
        if int(jref.hash_set(np.asarray(block), num_sets)) == target_set:
            out.append(block * epb)
        block += 1
    return np.asarray(out, np.int32)


def _assert_equal(got, want, op):
    """``got`` against ``want`` field by field (see the module docstring)."""
    for field, a, b in zip(("indices", "payload", "positions", "active"),
                           got, want):
        a, b = n(a), np.asarray(b)
        assert a.dtype == b.dtype, field
        if field == "payload" and op in ("add", "tagged") and \
                a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        else:
            assert np.array_equal(a, b), field


def _check(idx, sec, op, live=None, table=None, **kw):
    """The port's plain engine and oracle against the reference's engine
    and oracle on one stream; returns the port's result."""
    jkw = dict(kw, filter_op=op)
    want = jbanked(jnp.asarray(idx), jnp.asarray(sec),
                   n_live=None if live is None else jnp.int32(live),
                   tag_table=None if table is None else jnp.asarray(table),
                   **jkw)
    got = hash_reorder_banked(t(idx), t(sec), n_live=live,
                              tag_table=None if table is None else t(table),
                              **jkw)
    _assert_equal(got, want, op)
    if table is None:
        m = idx.shape[0] if live is None else live
        ref_want = jref.ragged_oracle(jref.hash_reorder_ref_banked, idx, sec,
                                      m, **jkw)
        ref_got = tref.ragged_oracle(tref.hash_reorder_ref_banked, idx, sec,
                                     m, **jkw)
        for a, b in zip(ref_got, ref_want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        _assert_equal(got, ref_want, op)
    return got


@pytest.mark.parametrize("n_partitions", [2, 4])
@pytest.mark.parametrize("op", [None, "add", "min", "max"])
def test_banked_matches_reference(n_partitions, op):
    rng = np.random.default_rng(17 * n_partitions)
    idx = rng.integers(0, 3000, 1500).astype(np.int32)
    sec = rng.random(1500).astype(np.float32)
    _check(idx, sec, op, num_sets=32, slots=8, n_partitions=n_partitions,
           round_cap=16)


@pytest.mark.parametrize("op", ["add", "min"])
@pytest.mark.parametrize("live", [0, 700, 1500])
def test_banked_ragged_matches_reference(op, live):
    """Partition fronts, then dead lanes in stream order, then the tails;
    the bypass decided on the live count."""
    rng = np.random.default_rng(21)
    idx = rng.integers(0, 3000, 1500).astype(np.int32)
    sec = rng.random(1500).astype(np.float32)
    got = _check(idx, sec, op, live, num_sets=32, slots=8, n_partitions=4,
                 round_cap=16)
    act = n(got[3])
    s = int(act.sum())
    assert act[:s].all() and not act[s:].any()


def test_banked_tagged_matches_reference():
    rng = np.random.default_rng(22)
    idx = rng.integers(0, 600, 1500).astype(np.int32)
    sec = rng.random(1500).astype(np.float32)
    table = rng.random(602) < 0.5
    _check(idx, sec, "tagged", 1100, table, num_sets=32, slots=8,
           n_partitions=4, round_cap=16)


@pytest.mark.parametrize("op", [None, "add", "min"])
def test_banked_2d_payloads(op):
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 400, 600).astype(np.int32)
    sec = rng.random((600, 3)).astype(np.float32)
    got = _check(idx, sec, op, num_sets=16, slots=4, n_partitions=4,
                 round_cap=8)
    assert tuple(got[1].shape) == (600, 3)


def test_banked_single_partition_is_flat_engine():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 500, 700).astype(np.int32)
    sec = rng.random(700).astype(np.float32)
    got = hash_reorder_banked(t(idx), t(sec), num_sets=32, slots=8,
                              n_partitions=1, filter_op="add")
    want = tref.hash_reorder_ref(idx, sec, num_sets=32, slots=8,
                                 filter_op="add")
    _assert_equal(got, want, "add")


@pytest.mark.parametrize("op", ["add", "min"])
def test_all_one_set_stream_takes_dense_fallback(op):
    num_sets, slots, cap = 16, 4, 4
    rng = np.random.default_rng(0)
    idx = rng.permutation(_same_set_indices(512, num_sets=num_sets))
    assert tref.max_round_bound(idx, num_sets=num_sets, slots=slots) > cap
    sec = rng.random(idx.shape[0]).astype(np.float32)
    kw = dict(num_sets=num_sets, slots=slots, n_partitions=4, round_cap=cap)
    got = _check(idx, sec, op, **kw)
    uncapped = tref.hash_reorder_ref_banked(idx, sec, filter_op=op,
                                            **{**kw, "round_cap": None})
    assert not np.array_equal(n(got[0]), uncapped[0])


def test_two_hot_sets_fallback_is_per_partition():
    """Hot partitions fall back, the rest keep hash semantics."""
    num_sets, slots, cap = 16, 4, 3
    hot_a = _same_set_indices(300, num_sets=num_sets, target_set=1)
    hot_b = _same_set_indices(300, num_sets=num_sets, target_set=6)
    rng = np.random.default_rng(1)
    cold = rng.integers(0, 10_000, 400).astype(np.int32)
    idx = np.empty(1000, np.int32)
    idx[0::2] = np.concatenate([hot_a, hot_b[:200]])
    idx[1::2] = np.concatenate([hot_b[200:], cold])
    sec = rng.random(1000).astype(np.float32)
    _check(idx, sec, "add", num_sets=num_sets, slots=slots, n_partitions=4,
           round_cap=cap)


@pytest.mark.parametrize("cap", [2, 8, None])
def test_zipf_skewed_stream_matches_reference(cap):
    rng = np.random.default_rng(7)
    idx = (rng.zipf(1.2, 2000) % 500).astype(np.int32)
    sec = rng.random(2000).astype(np.float32)
    _check(idx, sec, "add", num_sets=16, slots=4, n_partitions=4,
           round_cap=cap)


def test_capacity_overflow_bypasses_banking():
    """Every lane in one partition: the bank capacity is exceeded and the
    whole stream takes the flat path on both sides."""
    num_sets = 16
    idx = _same_set_indices(800, num_sets=num_sets)
    counts = np.bincount(tref.hash_set(idx // np.int32(32), num_sets) % 4,
                         minlength=4)
    assert counts.max() > tref.partition_capacity(idx.shape[0], 4)
    sec = np.random.default_rng(2).random(idx.shape[0]).astype(np.float32)
    got = _check(idx, sec, "add", num_sets=num_sets, slots=4, n_partitions=4,
                 round_cap=8)
    flat = tref.hash_reorder_ref_flat(idx, sec, num_sets=num_sets, slots=4,
                                      filter_op="add", round_cap=8)
    assert np.array_equal(n(got[0]), flat[0])


@pytest.mark.parametrize("n_lanes", [0, 1, 63, 64, 65, 1000, 8192, 10**7])
@pytest.mark.parametrize("n_partitions", [1, 2, 4, 8])
def test_partition_capacity_matches_reference(n_lanes, n_partitions):
    assert (tref.partition_capacity(n_lanes, n_partitions)
            == jref.partition_capacity(n_lanes, n_partitions))


@pytest.mark.parametrize("bad", [dict(num_sets=1023), dict(num_sets=30,
                                                           n_partitions=4),
                                 dict(n_partitions=0), dict(n_banks=0),
                                 dict(round_cap=0)])
def test_config_geometry_checks_match_reference(bad):
    with pytest.raises(ValueError):
        jiru.IRUConfig(**bad)
    with pytest.raises(ValueError):
        tiru.IRUConfig(**bad)


def test_bank_parallelism_matches_reference():
    for kw in (dict(), dict(n_partitions=4, n_banks=2),
               dict(n_partitions=2, n_banks=4)):
        assert (tiru.IRUConfig(**kw).bank_parallelism
                == jiru.IRUConfig(**kw).bank_parallelism)

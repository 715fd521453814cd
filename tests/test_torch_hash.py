"""Port parity: the IRU hash engine (``kernels/iru_reorder``) against the
reference's batched JAX engine and numpy oracles.

The plain version ``batched.hash_reorder_batched`` is held against
``repro.kernels.iru_reorder.batched.hash_reorder_batched`` and against
``ragged_oracle(hash_reorder_ref_flat, ...)`` on the same inputs.  Indices,
positions and active flags are bit-identical; ``min`` / ``max`` / unmerged
payloads are exact; merged ``add`` (and ``tagged``) payloads are held to
rtol 1e-5 (+ atol 1e-6 near zero), since the engines' scatters may add in
another order.  The port's copy of the oracles (``ref.py``) is
bit-identical to the reference's.

Each scenario is built to take one branch of the engine (the same branch in
both packages, which share their branch decisions), and
``test_each_branch_is_reached`` shows that it does.  Few distinct shapes
keep the JAX compile cache small.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.iru_reorder import batched as jbatched
from repro.kernels.iru_reorder import ref as jref
from repro_torch.core.iru import IRUConfig, IRUStream, iru_reorder
from repro_torch.kernels.iru_reorder import batched, ops
from repro_torch.kernels.iru_reorder import ref as tref
from torch_parity import n, t

N = 1500
BIG, SMALL = (1024, 32), (16, 4)
# name: ((num_sets, slots), stream, n_live, round_cap, branch taken with a
# filter op).  "wide" spreads over ~1500 blocks (every set fits one round
# at 1024 x 32); "hot" packs 600 indices into 19 blocks (many rounds at
# 16 x 4); "sparse" puts a 60-lane live prefix on 64 blocks, so some sets
# flush once and none twice (the two-generation form holds).
SCENARIOS = {
    "single_round": (BIG, "wide", None, None, "_keys_single_round"),
    "peeling": (SMALL, "hot", None, None, "_keys_hash_filter"),
    "two_gen": (SMALL, "sparse", 60, None, "_two_gen_emit"),
    "two_gen_declined": (SMALL, "hot", 1000, None, "_keys_hash_filter"),
    "all_dead": (SMALL, "hot", 0, None, "_two_gen_emit"),
    "all_live": (BIG, "wide", N, None, "_two_gen_emit"),
    "cap_padded": (SMALL, "hot", None, 3, "_dense_merge_flat"),
    "cap_ragged": (SMALL, "hot", 1000, 3, "_keys_dense_merge"),
}
OP_PAYLOADS = [(None, "float32"), ("add", "float32"), ("min", "float32"),
               ("max", "float32"), ("tagged", "float32"), ("add", "int32"),
               ("min", "int32"), ("add", "2d"), ("min", "2d")]
HIGH = {"wide": 50_000, "hot": 600, "sparse": 2048}


def _inputs(stream: str, payload: str):
    rng = np.random.default_rng(0)
    idx = rng.integers(0, HIGH[stream], N).astype(np.int32)
    if payload == "int32":
        sec = rng.integers(-500, 500, N).astype(np.int32)
    elif payload == "2d":
        sec = rng.standard_normal((N, 2)).astype(np.float32)
    else:
        sec = rng.standard_normal(N).astype(np.float32)
    tags = rng.random(HIGH[stream] + 2) < 0.5
    return idx, sec, tags


def _assert_same(want, got, op):
    for i, field in ((0, "indices"), (2, "positions"), (3, "active")):
        a, b = np.asarray(want[i]), n(got[i])
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    a, b = np.asarray(want[1]), n(got[1])
    assert a.dtype == b.dtype
    if op in ("add", "tagged") and a.dtype == np.float32:
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    else:
        assert np.array_equal(a, b)


@pytest.mark.parametrize("op,payload", OP_PAYLOADS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_batched_matches_reference_and_oracle(scenario, op, payload):
    (num_sets, slots), stream, live, cap, _ = SCENARIOS[scenario]
    idx, sec, tags = _inputs(stream, payload)
    kw = dict(num_sets=num_sets, slots=slots, filter_op=op, round_cap=cap)
    table = op == "tagged"
    want = jbatched.hash_reorder_batched(
        jnp.asarray(idx), jnp.asarray(sec), **kw,
        n_live=None if live is None else jnp.int32(live),
        tag_table=jnp.asarray(tags) if table else None)
    got = batched.hash_reorder_batched(
        t(idx), t(sec), **kw,
        n_live=None if live is None else torch.tensor(live, dtype=torch.int32),
        tag_table=t(tags) if table else None)
    _assert_same(want, got, op)
    if not table:  # the numpy oracle models single-family merges
        oracle = jref.ragged_oracle(jref.hash_reorder_ref_flat, idx, sec,
                                    N if live is None else live, **kw)
        _assert_same(oracle, got, op)


@pytest.fixture
def branches(monkeypatch):
    """Names of the engine's branch functions called, in order."""
    seen: list[str] = []
    for name in ("_keys_single_round", "_keys_hash_filter", "_two_gen_plan",
                 "_two_gen_emit", "_dense_merge_flat", "_keys_dense_merge",
                 "_keys_nofilter"):
        def spy(*args, _fn=getattr(batched, name), _name=name, **kw):
            seen.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(batched, name, spy)
    return seen


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_each_branch_is_reached(scenario, branches):
    (num_sets, slots), stream, live, cap, branch = SCENARIOS[scenario]
    idx, sec, _ = _inputs(stream, "float32")
    batched.hash_reorder_batched(t(idx), t(sec), num_sets=num_sets,
                                 slots=slots, filter_op="add", round_cap=cap,
                                 n_live=live)
    assert branch in branches, branches
    if live is not None:  # ragged streams try the two-generation form first
        assert branches[0] == "_two_gen_plan"
    if scenario == "two_gen":  # ... and some set did flush once
        m = idx[:live]
        sets = tref.hash_set(m // 32, num_sets)
        distinct = [np.unique(m[sets == s]).size for s in range(num_sets)]
        assert max(distinct) >= slots


def test_unmerged_stream_takes_the_closed_form(branches):
    idx, sec, _ = _inputs("hot", "float32")
    out = batched.hash_reorder_batched(t(idx), t(sec), num_sets=16, slots=4)
    assert branches == ["_keys_nofilter"]
    _assert_same(jref.hash_reorder_ref(idx, sec, num_sets=16, slots=4), out,
                 None)


@pytest.mark.parametrize("op", [None, "add", "min", "max"])
@pytest.mark.parametrize("geometry", [BIG, SMALL, (8, 2)])
def test_ref_copy_is_bit_identical(op, geometry):
    num_sets, slots = geometry
    rng = np.random.default_rng(num_sets)
    idx = rng.integers(-70, 700, 400).astype(np.int32)  # negative keys too
    sec = rng.standard_normal(400).astype(np.float32)
    kw = dict(num_sets=num_sets, slots=slots, filter_op=op)
    keys = idx.astype(np.int64) * 977
    assert np.array_equal(tref.hash_set(keys, num_sets),
                          jref.hash_set(keys, num_sets))
    assert (tref.max_round_bound(idx, num_sets=num_sets, slots=slots)
            == jref.max_round_bound(idx, num_sets=num_sets, slots=slots))
    pairs = [
        (tref.hash_reorder_ref(idx, sec, **kw),
         jref.hash_reorder_ref(idx, sec, **kw)),
        (tref.hash_reorder_ref_vec(idx, sec, **kw),
         jref.hash_reorder_ref_vec(idx, sec, **kw)),
        (tref.dense_merge_ref(idx, sec, filter_op=op),
         jref.dense_merge_ref(idx, sec, filter_op=op)),
        (tref.hash_reorder_ref_flat(idx, sec, round_cap=2, **kw),
         jref.hash_reorder_ref_flat(idx, sec, round_cap=2, **kw)),
        (tref.ragged_oracle(tref.hash_reorder_ref_vec, idx, sec, 250, **kw),
         jref.ragged_oracle(jref.hash_reorder_ref_vec, idx, sec, 250, **kw)),
    ]
    for got, want in pairs:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("length", [0, 1, 37])
def test_hash_set_matches_the_numpy_oracle(length):
    rng = np.random.default_rng(length)
    keys = rng.integers(-2**31, 2**31, length).astype(np.int32)
    for num_sets in (1, 16, 1000):
        got = batched.hash_set(t(keys), num_sets)
        assert got.dtype == torch.int32
        assert np.array_equal(n(got), tref.hash_set(keys, num_sets))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    idx, sec, _ = _inputs("hot", "float32")
    got = ops.hash_reorder(t(idx), t(sec), num_sets=16, slots=4,
                           filter_op="min", n_live=900)
    want = batched.hash_reorder_batched(t(idx), t(sec), num_sets=16, slots=4,
                                        filter_op="min", n_live=900)
    assert isinstance(got, IRUStream)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    plain = ops.hash_reorder(t(idx), t(sec), num_sets=16, slots=4,
                             filter_op="min", n_live=900, kernels=False)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    default = ops.hash_reorder(t(idx))
    assert default.secondary.dtype == torch.float32
    assert not default.secondary.any() and bool(default.active.all())


def test_wrapper_refuses_banked_and_unknown_ops():
    """The banked engine, once refused here, now runs its plain version
    (``tests/test_torch_banked.py`` holds it against the reference); a
    geometry that does not split over the partitions is refused."""
    idx = torch.arange(16, dtype=torch.int32)
    banked = ops.hash_reorder(idx, n_partitions=4)
    want = tref.hash_reorder_ref_banked(idx.numpy(), np.zeros(16, np.float32),
                                        n_partitions=4)
    for got, ref_field in zip(banked, want):
        assert np.array_equal(got.numpy(), ref_field)
    with pytest.raises(ValueError, match="n_partitions"):
        ops.hash_reorder(idx, num_sets=30, n_partitions=4)
    with pytest.raises(ValueError, match="filter op"):
        ops.hash_reorder(idx, filter_op="mul")
    with pytest.raises(ValueError, match="tag_table"):
        ops.hash_reorder(idx, filter_op="tagged")


@pytest.mark.parametrize("mode", ["hash", "hash_ref"])
def test_empty_stream(mode):
    out = iru_reorder(torch.zeros(0, dtype=torch.int32), torch.zeros(0),
                      config=IRUConfig(mode=mode, filter_op="add"), n_live=0)
    assert [x.shape[0] for x in out] == [0, 0, 0, 0]
    assert out.positions.dtype == torch.int32
    assert out.active.dtype == torch.bool

"""Port parity: ``core.filter`` and kernel B2 (segment merge).

Tolerances: survivor masks, ``min`` and ``max`` payloads are exact (order
free); ``add`` payloads are held to rtol 1e-5 (+ atol 1e-6 near zero),
because fp addition depends on the reduction order, which differs between
the scatter reduction, XLA's segment sum and the kernel's scans.  Integer
``add`` is exact.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filter as jfilt
from repro.kernels.segment_merge.segment_merge import segment_merge_pallas
from repro_torch.core import filter as filt
from repro_torch.kernels import launch_counts
from repro_torch.kernels.segment_merge import ops
from repro_torch.kernels.segment_merge.ref import segment_merge_ref
from torch_parity import n, sorted_stream as _sorted_stream, t

RTOL, ATOL = 1e-5, 1e-6


def _values(length: int, dtype: str, rng) -> np.ndarray:
    if dtype == "int32":
        return rng.integers(-1000, 1000, length).astype(np.int32)
    return rng.standard_normal(length).astype(np.float32)


def _assert_merge_equal(want, got, op, dtype, lanes=None):
    wv, ws = (np.asarray(x) for x in want)
    gv, gs = n(got[0]), n(got[1])
    assert np.array_equal(ws, gs)
    if lanes is not None:
        wv, gv = wv[lanes], gv[lanes]
    if op == "add" and dtype == "float32":
        np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL)
    else:
        assert np.array_equal(wv, gv)


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("live", [None, 0, 1, 257, 1000])
def test_merge_sorted_matches_reference(op, dtype, live):
    rng = np.random.default_rng(7)
    idx = _sorted_stream(1000, 150, rng)
    vals = _values(1000, dtype, rng)
    active = None if live is None else np.arange(1000) < live
    want = jfilt.merge_sorted(jnp.asarray(idx), jnp.asarray(vals), op,
                              active=None if active is None
                              else jnp.asarray(active))
    got = filt.merge_sorted(t(idx), t(vals), op,
                            active=None if active is None else t(active))
    _assert_merge_equal(want, got, op, dtype)
    got_ref = segment_merge_ref(t(idx), t(vals), op,
                                None if active is None else t(active))
    _assert_merge_equal(want, got_ref, op, dtype)


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_merge_sorted_matches_pallas_interpret(op, dtype):
    """Against the TPU kernel itself (interpret mode), on survivor lanes:
    the Pallas kernel only defines the merged value where a run starts."""
    rng = np.random.default_rng(13)
    idx = _sorted_stream(1300, 90, rng, long_run=700)  # crosses 512-chunks
    vals = _values(1300, dtype, rng)
    want = segment_merge_pallas(jnp.asarray(idx), jnp.asarray(vals), op=op,
                                interpret=True)
    got = filt.merge_sorted(t(idx), t(vals), op)
    _assert_merge_equal(want, got, op, dtype, lanes=np.asarray(want[1]))


def test_merge_sorted_two_dim_payload():
    rng = np.random.default_rng(21)
    idx = _sorted_stream(300, 40, rng)
    vals = rng.standard_normal((300, 3)).astype(np.float32)
    active = np.arange(300) < 211
    for op in ("add", "min"):
        want = jfilt.merge_sorted(jnp.asarray(idx), jnp.asarray(vals), op,
                                  active=jnp.asarray(active))
        got = filt.merge_sorted(t(idx), t(vals), op, active=t(active))
        _assert_merge_equal(want, got, op, "float32")


def test_merge_sorted_tagged_plain():
    rng = np.random.default_rng(17)
    idx = _sorted_stream(400, 60, rng)
    tag_table = rng.random(61) < 0.5
    tags = tag_table[idx]
    vals = rng.standard_normal(400).astype(np.float32)
    active = np.arange(400) < 333
    want = jfilt.merge_sorted(jnp.asarray(idx), jnp.asarray(vals), "tagged",
                              active=jnp.asarray(active),
                              tags=jnp.asarray(tags))
    got = filt.merge_sorted(t(idx), t(vals), "tagged", active=t(active),
                            tags=t(tags))
    _assert_merge_equal(want, got, "add", "float32")
    with pytest.raises(ValueError, match="tags"):
        filt.merge_sorted(t(idx), t(vals), "tagged")


def _assert_tagged_equal(want, got, tags, dtype, lanes=None):
    """Survivors and min-family lanes exactly; add-family lanes as ``add``."""
    keep = np.ones(tags.shape, bool) if lanes is None else lanes
    _assert_merge_equal(want, got, "min", dtype, lanes=keep & ~tags)
    _assert_merge_equal(want, got, "add", dtype, lanes=keep & tags)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("tail_family", ["add", "min"])
@pytest.mark.parametrize("live", [None, "prefix"])
def test_merge_sorted_tagged_matches_reference_and_pallas(dtype, tail_family,
                                                          live):
    """The plain tagged merge against the reference's ``merge_sorted`` on
    all lanes and its Pallas ``_kernel_tagged`` (interpret mode) on the
    survivors.  With an active prefix, the last live run and the dead tail
    behind it take opposite families: a dead lane's inert payload chosen by
    its own tag would poison the live run (``+inf`` into an add run)."""
    rng = np.random.default_rng(29)
    idx = _sorted_stream(1300, 90, rng, long_run=700)  # crosses 512-chunks
    vals = _values(1300, dtype, rng)
    table = rng.random(92) < 0.5
    active = None
    if live is not None:
        cut = 1000
        while idx[cut] == idx[cut - 1]:  # the dead tail starts a new index
            cut += 1
        active = np.arange(1300) < cut
        table[idx[cut - 1]] = tail_family == "add"
        table[idx[cut:]] = tail_family != "add"
    tags = table[idx]
    want = jfilt.merge_sorted(jnp.asarray(idx), jnp.asarray(vals), "tagged",
                              active=None if active is None
                              else jnp.asarray(active),
                              tags=jnp.asarray(tags))
    got = filt.merge_sorted(t(idx), t(vals), "tagged",
                            active=None if active is None else t(active),
                            tags=t(tags))
    _assert_tagged_equal(want, got, tags, dtype)
    assert np.isfinite(n(got[0]).astype(np.float64)[tags]).all()
    got_ref = segment_merge_ref(t(idx), t(vals), "tagged",
                                None if active is None else t(active),
                                t(tags))
    _assert_tagged_equal(want, got_ref, tags, dtype)
    if active is None:  # the Pallas kernel takes no active prefix
        pallas = segment_merge_pallas(jnp.asarray(idx), jnp.asarray(vals),
                                      jnp.asarray(tags), op="tagged",
                                      interpret=True)
        _assert_tagged_equal(pallas, got, tags, dtype,
                             lanes=np.asarray(pallas[1]))


def test_run_starts_segment_ids_filter_rate_compact():
    rng = np.random.default_rng(3)
    idx = _sorted_stream(200, 30, rng)
    active = np.arange(200) < 150
    ja, ta = jnp.asarray(active), t(active)
    assert np.array_equal(np.asarray(jfilt.run_starts(jnp.asarray(idx), ja)),
                          n(filt.run_starts(t(idx), ta)))
    assert np.array_equal(np.asarray(jfilt.segment_ids(jnp.asarray(idx), ja)),
                          n(filt.segment_ids(t(idx), ta)))
    surv = np.asarray(jfilt.run_starts(jnp.asarray(idx), ja))
    for act in (None, active):
        want = float(jfilt.filter_rate(jnp.asarray(surv), None if act is None
                                       else jnp.asarray(act)))
        got = float(filt.filter_rate(t(surv), None if act is None
                                     else t(act)))
        assert got == pytest.approx(want, rel=1e-6)
    pay = rng.standard_normal(200).astype(np.float32)
    want = jfilt.compact(jnp.asarray(surv), jnp.asarray(idx), jnp.asarray(pay))
    got = filt.compact(t(surv), t(idx), t(pay))
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), n(b))


def test_merge_ops_reject_unknown():
    with pytest.raises(ValueError):
        filt.merge_sorted(torch.zeros(3, dtype=torch.int32), torch.zeros(3),
                          "mul")
    with pytest.raises(ValueError):
        filt._merge_init("mul", torch.float32)


def test_plain_path_never_counts_a_launch():
    before = launch_counts["segment_merge"]
    ops.segment_merge(torch.zeros(4, dtype=torch.int32), torch.ones(4))
    assert launch_counts["segment_merge"] == before

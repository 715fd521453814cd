"""Port parity: MoE expert dispatch (``repro_torch.moe``,
``kernels/iru_reorder/dispatch.hash_dispatch``, ``models/moe``) against
``repro.moe`` and ``repro.models.moe``.

Shapes are the reference's own (``tests/test_moe_dispatch.py``): a few
hundred tokens, 3-16 experts.  The reference's params come from its
``Initializer`` and cross through ``convert.params_from_numpy``; tokens are
seeded numpy.  Plans are held bit for bit (every field) against the
reference's ``plan_dispatch`` and ``moe_dispatch_ref``.  Layer outputs are
held at rtol 1e-4, atol 1e-5 in f32 (the engines differ only in float sum
order), and in bf16 at 1/32 of the output's largest magnitude (8 bf16 ulps
of it: each of the reference and the port rounds every product to bf16, in
its own order).  Aux losses are equal across the port's engines and within
rtol 1e-6 of the reference's.  Gradients are held at rtol 1e-4 and an atol
of 1e-5 of each gradient's largest entry: ``sum(y**2)`` puts entries near
1e3 beside entries near 1e-1 that are sums of such terms, and f32 leaves
about one ulp of 1e3 (6e-5) on those.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import MoEConfig as JMoEConfig
from repro.kernels.iru_reorder.dispatch import hash_dispatch as j_hash_dispatch
from repro.kernels.iru_reorder.ref import moe_dispatch_ref as j_oracle
from repro.models.common import Initializer as JInitializer
from repro.models.moe import init_moe as j_init_moe
from repro.models.moe import moe_ffn as j_moe_ffn
from repro.moe import dispatch_stats as j_dispatch_stats
from repro.moe import format_stats as j_format_stats
from repro.moe import moe_hash as j_moe_hash
from repro.moe import plan_dispatch as j_plan_dispatch
from repro.moe.dispatch import _route as j_route
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.iru_reorder.dispatch import hash_dispatch
from repro_torch.kernels.iru_reorder.ref import moe_dispatch_ref
from repro_torch.models.common import Initializer
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.moe import (DispatchPlan, DispatchStats, capacity,
                             dispatch_stats, execute_plan, format_stats,
                             moe_hash, plan_dispatch)
from repro_torch.moe.dispatch import _route
from torch_parity import n

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINES = ("iru_hash", "iru_sorted", "dense")
PLAN_FIELDS = [f.name for f in dataclasses.fields(DispatchPlan)]
STATS_FIELDS = [f.name for f in dataclasses.fields(DispatchStats)]
# the reference's layer under one jit a configuration: one XLA compile
# costs well under the many small ones of an eager call
j_moe_ffn_jit = jax.jit(j_moe_ffn, static_argnums=(2, 3),
                        static_argnames=("dispatch",))
j_moe_hash_jit = jax.jit(j_moe_hash, static_argnums=(2, 3),
                         static_argnames=("return_stats",))


def _toy(seed, T, D, E, k, F, cf, ffn_type="swiglu", dtype="float32",
         n_shared=0):
    """The reference's params (its Initializer, ``PRNGKey(seed)``) and
    seeded numpy tokens, in both packages: ``(ref, port)`` where each is
    ``(params, moe, x)``."""
    kw = dict(n_experts=E, top_k=k, d_ff=F, capacity_factor=cf,
              n_shared_experts=n_shared)
    jmoe, tmoe = JMoEConfig(**kw), MoEConfig(**kw)
    it = JInitializer(jax.random.PRNGKey(seed), getattr(jnp, dtype))
    j_init_moe(it, D, jmoe, ffn_type)
    x = np.random.default_rng(seed).standard_normal((T, D)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return ((it.params, jmoe, jx),
            (params_from_numpy(it.params, "cpu"), tmoe, tx))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _zipf_experts(T, E, k):
    rng = np.random.default_rng(T * E + k)
    p = 1.0 / np.arange(1, E + 1)
    return rng.choice(E, size=(T, k), p=p / p.sum()).astype(np.int32)


# ---------------------------------------------------------------------------
# the planner, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,E,k,cap", [
    (64, 8, 2, 128),      # nothing drops
    (256, 4, 2, 16),      # uniform, binding
    (128, 16, 4, 8),      # many experts, deep k
    (500, 3, 1, 4),       # non-power-of-two everything
])
@pytest.mark.parametrize("n_partitions", [1, 4])
def test_plan_matches_reference_and_oracle(T, E, k, cap, n_partitions):
    experts = _zipf_experts(T, E, k)
    gates = np.random.default_rng(1).random((T, k)).astype(np.float32)
    want = j_plan_dispatch(jnp.asarray(experts), jnp.asarray(gates), cap, E,
                           n_partitions=n_partitions)
    got = plan_dispatch(torch.from_numpy(experts), torch.from_numpy(gates),
                        cap, E, n_partitions=n_partitions)
    for f in PLAN_FIELDS:
        a, b = np.asarray(getattr(want, f)), n(getattr(got, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    rank, keep, counts, dropped = moe_dispatch_ref(experts, cap, E)
    for mine, ref in zip((rank, keep, counts, dropped),
                         j_oracle(experts, cap, E)):
        np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(n(got.rank), rank)
    np.testing.assert_array_equal(n(got.keep), keep)
    np.testing.assert_array_equal(n(got.counts), counts)
    np.testing.assert_array_equal(n(got.dropped), dropped)


@pytest.mark.parametrize("n_live", [None, 0, 13, 40])
def test_hash_dispatch_generation_and_ragged(n_live):
    """generation == rank // slots (the flush round); dead lanes form the
    sentinel segment, every output equal to the reference's."""
    sets = np.zeros(40, np.int32)
    sets[::3] = 1
    kw = dict(num_sets=2, slots=8)
    jl = None if n_live is None else jnp.int32(n_live)
    tl = None if n_live is None else torch.tensor(n_live)
    want = j_hash_dispatch(jnp.asarray(sets), n_live=jl, **kw)
    got = hash_dispatch(torch.from_numpy(sets), n_live=tl, **kw)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(n(b), np.asarray(a))
        assert n(b).dtype == np.asarray(a).dtype
    if n_live is None:
        zero = hash_dispatch(torch.zeros(40, dtype=torch.int32), **kw)
        np.testing.assert_array_equal(n(zero[0]), np.arange(40))
        np.testing.assert_array_equal(n(zero[1]), np.arange(40) // 8)
        np.testing.assert_array_equal(n(zero[3]), [40, 0])


@pytest.mark.parametrize("m", [0, 37, 100])
def test_ragged_plan_matches_reference(m):
    T, E, k, cap = 100, 8, 2, 16
    experts = np.random.default_rng(9).integers(0, E, (T, k)).astype(np.int32)
    gates = np.ones((T, k), np.float32) / k
    want = j_plan_dispatch(jnp.asarray(experts), jnp.asarray(gates), cap, E,
                           n_live=jnp.int32(m))
    got = plan_dispatch(torch.from_numpy(experts), torch.from_numpy(gates),
                        cap, E, n_live=torch.tensor(m, dtype=torch.int32))
    for f in PLAN_FIELDS:  # dead lanes' sentinel bookkeeping included
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    rank, keep, counts, dropped = moe_dispatch_ref(experts, cap, E, n_live=m)
    live = n(got.live)
    assert live[:m * k].all() and not live[m * k:].any()
    np.testing.assert_array_equal(n(got.keep), keep)
    np.testing.assert_array_equal(n(got.counts), counts)
    np.testing.assert_array_equal(n(got.dropped), dropped)
    np.testing.assert_array_equal(n(got.rank)[:m * k], rank[:m * k])


# ---------------------------------------------------------------------------
# the three engines
# ---------------------------------------------------------------------------

# every distinct token count costs the reference some seconds of compiles,
# so the tests share these two sizes
SIZES = {"free": (0, 96, 32, 8, 2, 48, 8.0),       # no lane drops
         "binding": (3, 256, 16, 4, 2, 24, 0.5)}   # capacity binds


@pytest.mark.parametrize("regime", ["free", "binding"])
@pytest.mark.parametrize("ffn_type", ["swiglu", "gelu"])
def test_three_engines_match_each_other_and_reference(ffn_type, regime):
    (jp, jmoe, jx), (tp, tmoe, tx) = _toy(*SIZES[regime], ffn_type=ffn_type)
    C = capacity(tx.shape[0], tmoe)
    _, experts, _ = j_route(jp, jx, jmoe)
    dropped = j_oracle(np.asarray(experts), C, tmoe.n_experts)[3]
    assert (dropped.sum() > 0) == (regime == "binding")
    outs = {e: moe_ffn(tp, tx, tmoe, ffn_type, dispatch=e) for e in ENGINES}
    y0, a0 = outs["iru_hash"]
    for eng in ENGINES:
        y, a = outs[eng]
        np.testing.assert_allclose(n(y), n(y0), rtol=1e-4, atol=1e-5)
        assert float(a) == float(a0)
        yj, aj = j_moe_ffn_jit(jp, jx, jmoe, ffn_type, dispatch=eng)
        np.testing.assert_allclose(n(y), np.asarray(yj), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(float(a), float(aj), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_with_shared_experts_matches_reference(dtype):
    (jp, jmoe, jx), (tp, tmoe, tx) = _toy(*SIZES["free"], dtype=dtype,
                                           n_shared=2)
    assert tp["shared_wg"].dtype == getattr(torch, dtype)
    assert tp["router"].dtype == torch.float32
    x3 = tx.reshape(4, 24, 32)  # (B, S, D) in, (B, S, D) out
    y, aux = moe_ffn(tp, x3, tmoe, "swiglu", dispatch="iru_hash")
    yj, auxj = j_moe_ffn_jit(jp, jx.reshape(4, 24, 32), jmoe, "swiglu",
                             dispatch="iru_hash")
    assert y.shape == (4, 24, 32) and y.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(n(y), np.asarray(yj), rtol=1e-4,
                                   atol=1e-5)
    else:
        want = _f32(yj)
        np.testing.assert_allclose(_f32(y), want, rtol=0,
                                   atol=np.abs(want).max() / 32)
    np.testing.assert_allclose(float(aux), float(auxj), rtol=1e-6)


def test_moe_ffn_refuses_what_needs_the_planned_engine():
    _, (tp, tmoe, tx) = _toy(4, 32, 16, 4, 2, 24, 4.0)
    for kw in (dict(n_live=torch.tensor(16)), dict(n_shards=2),
               dict(return_stats=True)):
        with pytest.raises(ValueError, match="iru_hash"):
            moe_ffn(tp, tx, tmoe, "swiglu", dispatch="iru_sorted", **kw)
    with pytest.raises(ValueError, match="expert-parallel"):
        moe_ffn(tp, tx, tmoe, "swiglu", dispatch="iru_hash", n_shards=1,
                return_stats=True)
    with pytest.raises(ValueError, match="unknown dispatch"):
        moe_ffn(tp, tx, tmoe, "swiglu", dispatch="topk")


# ---------------------------------------------------------------------------
# ragged n_live
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [0, 60])
def test_ragged_prefix_matches_truncated_run_and_reference(m):
    (jp, jmoe, jx), (tp, tmoe, tx) = _toy(*SIZES["free"])
    T = tx.shape[0]
    yr, ar = moe_hash(tp, tx, tmoe, "swiglu", n_live=torch.tensor(m))
    assert not n(yr)[m:].any()          # dead tokens contribute nothing
    yj, aj = j_moe_hash_jit(jp, jx, jmoe, "swiglu", n_live=jnp.int32(m))
    np.testing.assert_allclose(n(yr), np.asarray(yj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(ar), float(aj), rtol=1e-6)
    if m == 0:
        assert float(ar) == 0.0
        return
    # the live prefix: same routing at the padded capacity
    C = capacity(T, tmoe)
    gates, experts, aux_small = _route(tp, tx[:m], tmoe)
    y_small = execute_plan(tp, tx[:m],
                           plan_dispatch(experts, gates, C, tmoe.n_experts),
                           C, "swiglu")
    np.testing.assert_allclose(n(yr[:m]), n(y_small), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(ar), float(aux_small), rtol=1e-6)


def test_planned_path_reads_nothing_on_the_host(monkeypatch):
    """With every host read of a tensor patched to raise, the planned path
    (route, plan, execute, stats, shared experts) still runs under a
    ragged ``n_live`` tensor, and gives what it gives unpatched."""
    _, (tp, tmoe, tx) = _toy(*SIZES["binding"], n_shared=1)
    m = torch.tensor(40)
    want = moe_ffn(tp, tx, tmoe, "swiglu", dispatch="iru_hash", n_live=m,
                   return_stats=True)
    want_ep = moe_ffn(tp, tx, tmoe, "swiglu", dispatch="iru_hash", n_live=m,
                      n_shards=2)

    def host_read(*_a, **_k):
        raise AssertionError("host read of a tensor")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    with pytest.raises(AssertionError, match="host read"):
        bool(m)
    got = moe_ffn(tp, tx, tmoe, "swiglu", dispatch="iru_hash", n_live=m,
                  return_stats=True)
    got_ep = moe_ffn(tp, tx, tmoe, "swiglu", dispatch="iru_hash", n_live=m,
                     n_shards=2)  # the int8-compressed combine
    monkeypatch.undo()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for f in STATS_FIELDS:
        assert torch.equal(getattr(got[2], f), getattr(want[2], f)), f
    assert torch.equal(got_ep[0], want_ep[0])


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_gradients_match_jax_grad(engine):
    (jp, jmoe, jx), (tp, tmoe, tx) = _toy(*SIZES["binding"], n_shared=1)

    def loss_j(p):
        y, aux = j_moe_ffn(p, jx, jmoe, "swiglu", dispatch=engine)
        return jnp.sum(y ** 2) + 0.01 * aux

    want = jax.jit(jax.grad(loss_j))(jp)
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    y, aux = moe_ffn(tp, tx, tmoe, "swiglu", dispatch=engine)
    ((y ** 2).sum() + 0.01 * aux).backward()
    assert set(want) == set(tp)
    for k, v in tp.items():
        g = n(v.grad)
        assert np.isfinite(g).all(), k
        w = np.asarray(want[k])
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    assert np.abs(n(tp["wi"].grad)).max() > 0
    assert np.abs(n(tp["router"].grad)).max() > 0


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_live", [None, 23])
def test_dispatch_stats_match_reference(n_live):
    T, E, k, cap = 64, 4, 2, 8
    rng = np.random.default_rng(2)
    experts = rng.integers(0, E, (T, k)).astype(np.int32)
    gates = np.ones((T, k), np.float32) / k
    probs = rng.random((T, E)).astype(np.float32)
    jl = None if n_live is None else jnp.int32(n_live)
    tl = None if n_live is None else torch.tensor(n_live)
    want = j_dispatch_stats(
        j_plan_dispatch(jnp.asarray(experts), jnp.asarray(gates), cap, E,
                        n_live=jl), probs=jnp.asarray(probs), n_live=jl)
    got = dispatch_stats(
        plan_dispatch(torch.from_numpy(experts), torch.from_numpy(gates),
                      cap, E, n_live=tl), probs=torch.from_numpy(probs),
        n_live=tl)
    for f in STATS_FIELDS:
        a, b = np.asarray(getattr(want, f)), n(getattr(got, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    assert format_stats(got) == j_format_stats(want)
    assert format_stats(got, max_experts=2) == j_format_stats(
        want, max_experts=2)


def test_moe_hash_return_stats():
    (jp, jmoe, jx), (tp, tmoe, tx) = _toy(*SIZES["binding"])
    y, aux, st = moe_hash(tp, tx, tmoe, "swiglu", return_stats=True)
    yj, auxj, stj = j_moe_hash_jit(jp, jx, jmoe, "swiglu",
                                   return_stats=True)
    assert int(st.n_routed) == tx.shape[0] * tmoe.top_k
    assert int(st.n_dropped) == int(stj.n_dropped) > 0
    np.testing.assert_allclose(n(st.mean_prob), np.asarray(stj.mean_prob),
                               rtol=1e-5, atol=1e-7)
    assert format_stats(st) == j_format_stats(stj)


# ---------------------------------------------------------------------------
# the parameter factory
# ---------------------------------------------------------------------------

def test_initializer_builds_params_and_specs_in_lockstep():
    moe = MoEConfig(n_experts=4, top_k=2, d_ff=24, n_shared_experts=1)
    jit = JInitializer(jax.random.PRNGKey(0), jnp.bfloat16)
    j_init_moe(jit, 16, JMoEConfig(**dataclasses.asdict(moe)), "swiglu")
    it = Initializer(torch.Generator().manual_seed(0), device="cpu")
    init_moe(it, 16, moe, "swiglu")
    assert it.specs == jit.specs
    for k, v in it.params.items():
        ref = jit.params[k]
        assert tuple(v.shape) == ref.shape, k
        assert str(v.dtype).split(".")[-1] == str(ref.dtype), k
    # fan-in of a stacked expert weight is its leading dim, as in the
    # reference: std 1/sqrt(E)
    w = it.params["wi"].float()
    assert abs(float(w.std()) - 0.5) < 0.05
    child = it.sub("block")
    child.weight("g", (3,), ("embed",), init="ones")
    assert it.specs["block"] == {"g": ("embed",)}
    assert torch.equal(it.params["block"]["g"], torch.ones(3, dtype=it.dtype))
    again = Initializer(torch.Generator().manual_seed(0), device="cpu")
    init_moe(again, 16, moe, "swiglu")
    for k, v in it.params.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, again.params[k]), k


def test_chip_smoke_moe_layer_is_deepseek_v2_lite():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = get_config("deepseek-v2-lite-16b")
    want = dict(d_model=cfg.d_model, ffn_type=cfg.ffn_type,
                n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                d_ff=cfg.moe.d_ff, n_shared_experts=cfg.moe.n_shared_experts,
                capacity_factor=cfg.moe.capacity_factor)
    assert smoke.DEEPSEEK_V2_LITE_MOE == want
    moe = MoEConfig(**{k: v for k, v in want.items()
                       if k not in ("d_model", "ffn_type")})
    assert [capacity(t, moe) for t in smoke.MOE_TOKENS] == [512, 1920]

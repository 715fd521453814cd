"""Port parity: expert-parallel MoE (``repro_torch.moe.ep``), the int8
collectives (``repro_torch.dist.collectives``) and the blockwise quantizer
(``repro_torch.optim.adamw``) against ``repro.moe.ep``,
``repro.dist.collectives`` and ``repro.optim.adamw``.

The port's ``n_shards`` is the reference mesh's partition-axis size: at
``n_shards=1`` it is held against the reference on ``make_iru_mesh(4)``'s
degenerate one-device mesh, and at ``n_shards=4`` against the reference on
four forced host devices (one subprocess, as
``tests/test_moe_dispatch.py`` does).  The exact combine is held at rtol
1e-5, atol 1e-6 against the port's own single-device layer (the
reference's tolerance for the same check), and at rtol 1e-5 with an atol of
1e-6 of the output's largest magnitude against the reference (the two
packages' f32 matmuls sum in different orders: entries near zero differ by
about 1e-6 of the largest); the int8-compressed one within ``n_shards`` quanta (a
block's largest magnitude / 127) of the reference's compressed result in
every 128-block, since the two quantize the same partials, whose f32 sums
may differ by an ulp and so flip a code.  The quantizer's codes and scales
are bit-equal to the reference's.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.dist.collectives import compress_grads_int8_ef as j_compress
from repro.launch.mesh import make_iru_mesh
from repro.models.common import Initializer as JInitializer
from repro.models.moe import init_moe as j_init_moe
from repro.moe import moe_hash_ep as j_moe_hash_ep
from repro.optim.adamw import dequantize_i8 as j_dequantize_i8
from repro.optim.adamw import quantize_i8 as j_quantize_i8
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import params_from_numpy
from repro_torch.dist.collectives import allreduce_int8, compress_grads_int8_ef
from repro_torch.models.moe import moe_ffn
from repro_torch.moe import moe_hash, moe_hash_ep
from repro_torch.optim.adamw import _blocked, dequantize_i8, quantize_i8
from torch_parity import n

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, D, E, K, F = 64, 32, 8, 2, 48
# one XLA compile a configuration costs well under an eager call's many
j_moe_hash_ep_jit = jax.jit(j_moe_hash_ep, static_argnums=(2, 3, 4),
                            static_argnames=("n_partitions", "compress"))


@pytest.fixture(scope="module")
def toy():
    """The reference's degenerate-mesh case: params from its Initializer,
    seeded numpy tokens, in both packages."""
    moe_kw = dict(n_experts=E, top_k=K, d_ff=F, capacity_factor=8.0)
    jmoe = JMoEConfig(**moe_kw)
    it = JInitializer(jax.random.PRNGKey(7), jnp.float32)
    j_init_moe(it, D, jmoe, "swiglu")
    x = np.random.default_rng(7).standard_normal((T, D)).astype(np.float32)
    return ((it.params, jmoe, jnp.asarray(x)),
            (params_from_numpy(it.params, "cpu"), MoEConfig(**moe_kw),
             torch.from_numpy(x)))


def _close_to_reference(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def _quanta_ok(got: np.ndarray, want: np.ndarray, n_shards: int) -> None:
    """|got - want| within ``n_shards`` quanta of each 128-block of
    ``want`` (flat layout, the quantizer's blocks)."""
    g, w = got.reshape(-1), want.reshape(-1)
    pad = (-w.shape[0]) % 128
    wb = np.pad(w, (0, pad)).reshape(-1, 128)
    db = np.pad(np.abs(g - w), (0, pad)).reshape(-1, 128)
    quantum = np.abs(wb).max(1, keepdims=True) / 127.0
    assert (db <= n_shards * quantum).all(), (db - n_shards * quantum).max()


# ---------------------------------------------------------------------------
# the expert-parallel executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("n_partitions", [None, 2, 8])
def test_one_shard_matches_reference_degenerate_mesh(toy, n_partitions,
                                                     compress):
    (jp, jmoe, jx), (tp, tmoe, tx) = toy
    mesh = make_iru_mesh(4)
    assert mesh.shape["part"] == 1
    yj, aj = j_moe_hash_ep_jit(jp, jx, jmoe, "swiglu", mesh,
                               n_partitions=n_partitions, compress=compress)
    y, aux = moe_hash_ep(tp, tx, tmoe, "swiglu", n_shards=1,
                         n_partitions=n_partitions, compress=compress)
    _close_to_reference(n(y), np.asarray(yj))
    np.testing.assert_allclose(float(aux), float(aj), rtol=1e-6)
    yh, ah = moe_hash(tp, tx, tmoe, "swiglu")
    np.testing.assert_allclose(n(y), n(yh), rtol=1e-5, atol=1e-6)
    assert float(aux) == float(ah)


@pytest.mark.parametrize("n_shards,n_partitions", [(2, None), (2, 4),
                                                   (4, 8), (8, None)])
def test_shards_match_the_planner(toy, n_shards, n_partitions):
    """Exact combine over several shards equals the single-device layer;
    the compressed one stays within its quanta; ragged rows stay zero."""
    _, (tp, tmoe, tx) = toy
    yh, ah = moe_hash(tp, tx, tmoe, "swiglu")
    y, aux = moe_hash_ep(tp, tx, tmoe, "swiglu", n_shards=n_shards,
                         n_partitions=n_partitions, compress=False)
    np.testing.assert_allclose(n(y), n(yh), rtol=1e-5, atol=1e-6)
    assert float(aux) == float(ah)
    yc, _ = moe_hash_ep(tp, tx, tmoe, "swiglu", n_shards=n_shards,
                        n_partitions=n_partitions)
    err = np.abs(n(yc) - n(yh)).max()
    assert err <= 0.05 * np.abs(n(yh)).max() + 1e-3
    yr, _ = moe_hash_ep(tp, tx, tmoe, "swiglu", n_shards=n_shards,
                        n_partitions=n_partitions, n_live=torch.tensor(40),
                        compress=False)
    yhr, _ = moe_hash(tp, tx, tmoe, "swiglu", n_live=torch.tensor(40))
    assert not n(yr)[40:].any()
    np.testing.assert_allclose(n(yr), n(yhr), rtol=1e-5, atol=1e-6)
    ym, _ = moe_ffn(tp, tx, tmoe, "swiglu", dispatch="iru_hash",
                    n_shards=n_shards)
    if n_partitions is None:
        assert torch.equal(ym, yc)


def test_geometry_errors_match_reference(toy):
    (jp, jmoe, jx), (tp, tmoe, tx) = toy
    with pytest.raises(ValueError, match="partitions") as want:
        j_moe_hash_ep(jp, jx, jmoe, "swiglu", make_iru_mesh(1),
                      n_partitions=3)
    with pytest.raises(ValueError, match="partitions") as got:
        moe_hash_ep(tp, tx, tmoe, "swiglu", n_shards=1, n_partitions=3)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        moe_hash_ep(tp, tx, tmoe, "swiglu", n_shards=3, n_partitions=4)
    assert str(got.value) == ("n_partitions=4 must be divisible by mesh "
                              "axis 'part' size 3")
    with pytest.raises(ValueError, match="must split across 3"):
        moe_hash_ep(tp, tx, tmoe, "swiglu", n_shards=3)


# ---------------------------------------------------------------------------
# the quantizer and the collectives
# ---------------------------------------------------------------------------

SHAPES = [(128,), (300,), (2, 130), (3, 5, 64), (1,)]


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_i8_is_bit_equal_to_reference(shape):
    rng = np.random.default_rng(len(shape) * 31 + shape[-1])
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 3, shape)
         ).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    if x.size >= 128:
        x.reshape(-1)[:128] = 0.0  # an all-zero block
    want = j_quantize_i8(jnp.asarray(x))
    got = quantize_i8(torch.from_numpy(x))
    for key in ("q", "scale"):
        a, b = np.asarray(want[key]), n(got[key])
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(
        n(dequantize_i8(got, shape)),
        np.asarray(j_dequantize_i8(want, shape)))
    blocks, pad = _blocked(torch.from_numpy(x))
    assert blocks.shape[1] == 128 and pad == (-x.size) % 128


def test_quantize_i8_rounds_half_to_even():
    x = torch.zeros(128)
    x[0] = 127.0                      # scale 1: codes are round(x)
    x[1:5] = torch.tensor([0.5, 1.5, 2.5, -0.5])
    np.testing.assert_array_equal(n(quantize_i8(x)["q"])[0, :5],
                                  [127, 0, 2, 2, 0])


def test_compress_grads_int8_ef_is_bit_equal_to_reference():
    rng = np.random.default_rng(3)
    grads = {"w": rng.standard_normal((4, 70)).astype(np.float32),
             "blk": {"b": rng.standard_normal(130).astype(np.float32),
                     "g": rng.standard_normal((3, 3)).astype(np.float32)}}
    ef = {"w": rng.standard_normal((4, 70)).astype(np.float32) * 1e-3,
          "blk": {"b": np.zeros(130, np.float32),
                  "g": rng.standard_normal((3, 3)).astype(np.float32)}}
    jt = jax.tree.map(jnp.asarray, (grads, ef))
    want = j_compress(*jt)
    got = compress_grads_int8_ef(params_from_numpy(grads, "cpu"),
                                 params_from_numpy(ef, "cpu"))
    for w_tree, g_tree in zip(want, got):
        flat_w = jax.tree.leaves(w_tree)
        flat_g = [g_tree["blk"]["b"], g_tree["blk"]["g"], g_tree["w"]]
        for a, b in zip(flat_w, flat_g):
            np.testing.assert_array_equal(n(b), np.asarray(a))
    # nothing is lost: dequantized + new residue == grad + residue
    for k in ("w",):
        np.testing.assert_array_equal(
            n(got[0][k] + got[1][k]), grads[k] + ef[k])


@pytest.mark.parametrize("rows,n_shards", [(4, 4), (8, 4), (6, 2), (3, 1)])
def test_allreduce_int8_is_the_reference_quantizer_per_shard(rows, n_shards):
    x = np.random.default_rng(rows).standard_normal(
        (rows, 5, 40)).astype(np.float32)
    got = n(allreduce_int8(torch.from_numpy(x), n_shards))
    parts = []
    for blk in np.split(x, n_shards):
        local = jnp.asarray(blk).sum(axis=0)
        parts.append(np.asarray(
            j_dequantize_i8(j_quantize_i8(local), local.shape)))
    want = np.sum(parts, axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_allreduce_int8_refuses_rows_that_do_not_divide():
    with pytest.raises(ValueError, match="does not divide over 4 shards"):
        allreduce_int8(torch.zeros(6, 3), 4)


# ---------------------------------------------------------------------------
# four shards against the reference on four devices
# ---------------------------------------------------------------------------

_CHILD = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs.base import MoEConfig
from repro.launch.mesh import make_iru_mesh
from repro.models.common import Initializer
from repro.models.moe import init_moe
from repro.moe import moe_hash, moe_hash_ep
assert len(jax.devices()) == 4, jax.devices()
mesh = make_iru_mesh(4)
assert mesh.shape["part"] == 4
ep = jax.jit(moe_hash_ep, static_argnums=(2, 3, 4),
             static_argnames=("n_partitions", "compress"))
T, D, E, k, F = 128, 32, 8, 2, 48
moe = MoEConfig(n_experts=E, top_k=k, d_ff=F, capacity_factor=2.0)
it = Initializer(jax.random.PRNGKey(0), jnp.float32)
init_moe(it, D, moe, "swiglu")
x = jax.random.normal(jax.random.PRNGKey(1), (T, D), jnp.float32)
out = {k: np.asarray(v) for k, v in it.params.items()}
out["x"] = np.asarray(x)
out["y"], out["aux"] = map(np.asarray, moe_hash(it.params, x, moe, "swiglu"))
out["ye"], out["auxe"] = map(np.asarray, ep(
    it.params, x, moe, "swiglu", mesh, n_partitions=8, compress=False))
out["yc"] = np.asarray(ep(it.params, x, moe, "swiglu", mesh,
                          compress=True)[0])
out["yr"] = np.asarray(ep(it.params, x, moe, "swiglu", mesh,
                          n_live=jnp.int32(70), compress=False)[0])
np.savez(OUT, **out)
print("OK")
"""


def test_four_shards_match_reference_on_four_devices(tmp_path):
    path = str(tmp_path / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    code = f"OUT = {path!r}\n" + textwrap.dedent(_CHILD)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    ref = np.load(path)
    moe = MoEConfig(n_experts=8, top_k=2, d_ff=48, capacity_factor=2.0)
    params = params_from_numpy(
        {k: ref[k] for k in ("router", "wi", "wg", "wo")}, "cpu")
    x = torch.from_numpy(ref["x"])
    y, aux = moe_hash(params, x, moe, "swiglu")
    _close_to_reference(n(y), ref["y"])
    ye, auxe = moe_hash_ep(params, x, moe, "swiglu", n_shards=4,
                           n_partitions=8, compress=False)
    _close_to_reference(n(ye), ref["ye"])
    np.testing.assert_allclose(float(auxe), float(ref["auxe"]), rtol=1e-6)
    yc, _ = moe_hash_ep(params, x, moe, "swiglu", n_shards=4, compress=True)
    _quanta_ok(n(yc), ref["yc"], 4)
    assert np.abs(ref["yc"] - ref["y"]).max() > 0  # the codec is lossy
    yr, _ = moe_hash_ep(params, x, moe, "swiglu", n_shards=4,
                        n_live=torch.tensor(70), compress=False)
    assert not n(yr)[70:].any() and not ref["yr"][70:].any()
    _close_to_reference(n(yr), ref["yr"])

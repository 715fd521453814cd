"""Port parity: LM training (``repro_torch.optim``, ``repro_torch.train``,
``repro_torch.data``) against ``repro.optim``, ``repro.train`` and
``repro.data``.

Inputs are seeded numpy handed to both packages.  The train-step tests run
both packages on one set of params: the port's ``init_params`` (a seeded
CPU generator), carried to the reference as numpy after checking that the
tree equals the reference's (its own ``init_params`` compiles threefry
draws for every shape).  The reference is called under ``jax.jit``.
Everything runs in f32 except where bf16 is the point.

Tolerances: AdamW with fp32 moments within 1e-6 relative, bf16 within one
bf16 ulp, int8 codes equal but for off-by-one on at most 1e-3 of lanes
(``log2``/``exp2`` may differ in the last ulp) with scales and ``lo``/``hi``
within 1e-6; the loss within rtol 1e-5; gradients within 1e-4 of each
leaf's largest magnitude; train-step metrics within rtol 1e-5; batches bit
for bit.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ParallelConfig as JParallelConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import pipeline as JD
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.optim import schedule as JS
from repro.train import losses as JL
from repro.train import trainer as JTR
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.convert import params_from_numpy
from repro_torch.data import pipeline as D
from repro_torch.models import transformer as T
from repro_torch.models.measure import tree_leaves
from repro_torch.optim import adamw as A
from repro_torch.optim import schedule as S
from repro_torch.train import losses as L
from repro_torch.train import trainer as TR
from torch_parity import n

# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


# a param near zero is the difference of p and lr * update: hold it to 1e-6
# of the update's size (lr = 1e-2), not of the result
ATOL_P = 1e-8


def _opt_inputs(seed: int):
    """A small param tree: a matrix, a stacked 3-d leaf whose size is not a
    multiple of the 128-block, a bf16 vector and a ragged vector."""
    rng = np.random.default_rng(seed)
    p = {"w": rng.standard_normal((64, 48)).astype(np.float32),
         "stack": {"k": rng.standard_normal((3, 5, 130)).astype(np.float32)},
         "b16": rng.standard_normal(300).astype(np.float32),
         "v": rng.standard_normal(7).astype(np.float32)}
    g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.3)
                     .astype(np.float32), p)
    return p, g


def _jax_tree(tree, bf16_keys=("b16",)):
    return {k: (_jax_tree(v) if isinstance(v, dict) else
                jnp.asarray(v, jnp.bfloat16 if k in bf16_keys else None))
            for k, v in tree.items()}


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _hold_moment(got, want, dtype: str, what: str) -> None:
    if dtype == "int8":
        q_got, q_want = n(got["q"]).astype(int), np.asarray(want["q"]).astype(int)
        diff = np.abs(q_got - q_want)
        assert diff.max() <= 1, (what, diff.max())
        assert (diff > 0).mean() <= 1e-3, (what, (diff > 0).mean())
        for k in want:
            if k != "q":
                np.testing.assert_allclose(n(got[k]), np.asarray(want[k]),
                                           rtol=1e-6, atol=1e-30, err_msg=what)
        return
    g = n(got.float())
    w = np.asarray(want.astype(jnp.float32))
    if dtype == "bf16":
        assert np.all(np.abs(g - w) <= _bf16_ulp(w)), what
    else:  # m's two terms cancel near zero: 1e-6 of the leaf's largest there
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=what)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_adamw_update_matches_reference(dtype):
    """Two steps: the first from zero moments, the second from the
    reference's state after the first, carried across."""
    cfg = A.AdamWConfig(lr=1e-2, state_dtype=dtype)
    jcfg = JA.AdamWConfig(lr=1e-2, state_dtype=dtype)
    p0, g0 = _opt_inputs(0)
    jp = _jax_tree(p0)
    jstate = JA.adamw_init(jp, jcfg)
    tstate = A.adamw_init(params_from_numpy(jp, "cpu"), cfg)
    jax.tree.map(lambda a, b: _hold_moment(a, b, dtype, "init"),
                 tstate["m"], jstate["m"],
                 is_leaf=lambda x: isinstance(x, torch.Tensor) or (
                     isinstance(x, dict) and "q" in x))
    upd = jax.jit(lambda p, g, s, lr: JA.adamw_update(p, g, s, jcfg, lr))
    for step in range(2):
        _, g = _opt_inputs(step + 1)
        jg = jax.tree.map(jnp.asarray, g)
        lr = np.float32(0.7)
        tp = params_from_numpy(jp, "cpu")
        ts = params_from_numpy(jstate, "cpu")
        jp, jstate = upd(jp, jg, jstate, lr)
        got_p, got_s = A.adamw_update(tp, params_from_numpy(g, "cpu"), ts,
                                      cfg, torch.tensor(lr))
        assert got_p is tp and got_s is ts  # in place
        assert int(got_s["step"]) == int(jstate["step"]) == step + 1
        for name in ("w", "v", "b16"):
            want = np.asarray(jp[name].astype(jnp.float32))
            got = n(got_p[name].float())
            assert got_p[name].dtype == (torch.bfloat16 if name == "b16"
                                         else torch.float32)
            if name == "b16":
                assert np.all(np.abs(got - want) <= _bf16_ulp(want)), step
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL_P)
        np.testing.assert_allclose(n(got_p["stack"]["k"]),
                                   np.asarray(jp["stack"]["k"]), rtol=1e-6,
                                   atol=ATOL_P)
        for key in ("m", "v"):
            for name in ("w", "v", "b16"):
                _hold_moment(got_s[key][name], jstate[key][name], dtype,
                             f"{key}/{name} step {step}")
            _hold_moment(got_s[key]["stack"]["k"], jstate[key]["stack"]["k"],
                         dtype, f"{key}/stack step {step}")


def test_adamw_chunked_update_equals_one_chunk(monkeypatch):
    """The leaf walk in ``_CHUNK`` pieces gives the same bits as one piece
    (int8 blocks are never cut).  The clip is held at 1: the global norm's
    sum runs in chunks too, and its order moves its last bit."""
    cfg = A.AdamWConfig(lr=1e-2, state_dtype="int8", grad_clip=1e9)
    p0, g0 = _opt_inputs(3)
    runs = []
    for chunk in (A._CHUNK, 256):
        monkeypatch.setattr(A, "_CHUNK", chunk)
        p = params_from_numpy(p0, "cpu")
        g = params_from_numpy(g0, "cpu")
        s = A.adamw_init(p, cfg)
        for _ in range(2):
            A.adamw_update(p, g, s, cfg)
        runs.append(tree_leaves({"p": p, "s": s}))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_quantizers_round_trip_like_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 7)).astype(np.float32)
    v = np.abs(x) * 10.0 ** rng.uniform(-8, 0, x.shape).astype(np.float32)
    jq, tq = JA.quantize_i8(jnp.asarray(x)), A.quantize_i8(torch.from_numpy(x))
    assert np.array_equal(n(tq["q"]), np.asarray(jq["q"]))
    np.testing.assert_allclose(n(tq["scale"]), np.asarray(jq["scale"]),
                               rtol=1e-6)
    np.testing.assert_allclose(n(A.dequantize_i8(tq, x.shape)),
                               np.asarray(JA.dequantize_i8(jq, x.shape)),
                               rtol=1e-6, atol=1e-12)
    jl = JA.quantize_i8_log(jnp.asarray(v))
    tl = A.quantize_i8_log(torch.from_numpy(v))
    _hold_moment(tl, jl, "int8", "quantize_i8_log")
    back = n(A.dequantize_i8_log(tl, v.shape))
    want = np.asarray(JA.dequantize_i8_log(jl, v.shape))
    same = (n(tl["q"]) == np.asarray(jl["q"])).reshape(-1)[:v.size]
    same = same.reshape(v.shape)  # lanes whose codes agree decode alike
    np.testing.assert_allclose(back[same], want[same], rtol=1e-5)
    rel = np.abs(back - v) / np.maximum(v, 1e-20)
    assert np.median(rel) < 0.15  # the reference's own bound


def test_global_norm_and_schedules_match_reference():
    p, g = _opt_inputs(0)
    np.testing.assert_allclose(
        float(A.global_norm(params_from_numpy(g, "cpu"))),
        float(JA.global_norm(jax.tree.map(jnp.asarray, g))), rtol=1e-6)
    steps = np.arange(0, 130, dtype=np.int32)
    for warmup, total in ((10, 100), (1, 1), (0, 50)):
        want = np.asarray(jax.vmap(lambda s: JS.linear_warmup_cosine(
            s, warmup, total))(jnp.asarray(steps)))
        got = n(S.linear_warmup_cosine(torch.from_numpy(steps), warmup,
                                       total))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    want = np.asarray(JS.cosine_schedule(jnp.asarray(steps), 100,
                                         final_frac=0.2))
    got = n(S.cosine_schedule(torch.from_numpy(steps), 100, final_frac=0.2))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _quadratic_losses(state_dtype: str, steps: int = 30) -> list[float]:
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 64)).astype(np.float32))
    params = {"w": torch.zeros(64, 64)}
    cfg = A.AdamWConfig(lr=5e-2, weight_decay=0.0, state_dtype=state_dtype)
    state = A.adamw_init(params, cfg)
    losses = []
    for _ in range(steps):
        g = {"w": 2 * (params["w"] - target)}
        losses.append(float(((params["w"] - target) ** 2).mean()))
        params, state = A.adamw_update(params, g, state, cfg)
    return losses


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_adamw_descends_quadratic(dtype):
    losses = _quadratic_losses(dtype)
    assert losses[-1] < 0.1 * losses[0], losses[::10]


def test_int8_adam_tracks_fp32():
    a, b = _quadratic_losses("fp32"), _quadratic_losses("int8")
    np.testing.assert_allclose(b[-1], a[-1], rtol=0.5)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab_real", [None, 33])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_softmax_xent_and_grad_match_reference(vocab_real, z_loss):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 5, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab_real or 40, (2, 5)).astype(np.int32)
    f = jax.jit(jax.value_and_grad(lambda lg: JL.softmax_xent(
        lg, jnp.asarray(labels), z_loss=z_loss, vocab_real=vocab_real)))
    want, wgrad = f(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = L.softmax_xent(lg, torch.from_numpy(labels), z_loss=z_loss,
                         vocab_real=vocab_real)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(n(lg.grad), np.asarray(wgrad), rtol=1e-5,
                               atol=1e-9)
    if vocab_real:
        assert not lg.grad[..., vocab_real:].any()


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def _data_cfgs(name: str):
    arch = {"tokens": "qwen3-32b", "vlm": "llava-next-34b",
            "embeds": "qwen3-32b", "frames": "whisper-medium"}[name]
    jcfg, tcfg = j_smoke_config(arch), smoke_config(arch)
    if name == "embeds":  # no registry arch takes this branch by itself
        jcfg = dataclasses.replace(jcfg, frontend="embeds")
        tcfg = dataclasses.replace(tcfg, frontend="embeds")
    return jcfg, tcfg


@pytest.mark.parametrize("name", ["tokens", "vlm", "embeds", "frames"])
def test_make_batch_is_bit_identical_to_reference(name):
    jcfg, tcfg = _data_cfgs(name)
    for step in (0, 5):
        want = JD.make_batch(jcfg, JShapeConfig("t", 32, 2, "train"), step,
                             JD.DataConfig(seed=3))
        got = D.make_batch(tcfg, ShapeConfig("t", 32, 2, "train"), step,
                           D.DataConfig(seed=3), device="cpu")
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = np.asarray(w)
            if w.dtype.name == "bfloat16":
                assert got[k].dtype == torch.bfloat16
                assert np.array_equal(
                    n(got[k].view(torch.int16)).view(np.uint16),
                    w.view(np.uint16)), k
            else:
                assert str(got[k].dtype) == f"torch.{w.dtype}", k
                assert np.array_equal(n(got[k]), w), k
    specs, axes = D.batch_specs(tcfg, ShapeConfig("t", 32, 2, "train"))
    jspecs, jaxes = JD.batch_specs(jcfg, JShapeConfig("t", 32, 2, "train"))
    assert axes == jaxes
    for k, s in specs.items():
        assert s.device.type == "meta" and tuple(s.shape) == jspecs[k].shape


def test_stream_resumes_and_labels_are_shifted_tokens():
    cfg, shape = smoke_config("qwen3-32b"), ShapeConfig("t", 64, 4, "train")
    s1 = D.synthetic_stream(cfg, shape, 0, device="cpu")
    for _ in range(3):
        step, batch = next(s1)
    step2, batch2 = next(D.synthetic_stream(cfg, shape, 2, device="cpu"))
    assert step == step2 == 2
    assert torch.equal(batch["tokens"], batch2["tokens"])
    assert not torch.equal(batch["tokens"],
                           D.make_batch(cfg, shape, 3, device="cpu")["tokens"])
    assert torch.equal(batch["labels"][:, :-1], batch["tokens"][:, 1:])
    assert torch.equal(batch["labels"][:, -1], batch["tokens"][:, 0])


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

# (arch, microbatches, remat, grad_compression, moment dtype)
STEP_CASES = (
    ("qwen3-32b", 1, "none", None, "fp32"),
    ("deepseek-v2-lite-16b", 2, "full", None, "fp32"),
    ("mamba2-130m", 1, "full", "int8_ef", "bf16"),
    ("jamba-1.5-large-398b", 1, "none", None, "fp32"),
    ("whisper-medium", 2, "none", None, "fp32"),
    ("llava-next-34b", 1, "full", None, "int8"),
)
SHAPE = (32, 4)  # S, B


def _step_setup(arch, mb, remat, comp, sd):
    jcfg = dataclasses.replace(j_smoke_config(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(smoke_config(arch), dtype=torch.float32)
    if jcfg.moe is not None:  # the planned engine, whose stats are logged
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, dispatch="iru_hash"))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, dispatch="iru_hash"))
    kw = dict(model_axis=1, remat=remat, microbatches=mb, attn_chunk=16)
    jpcfg, pcfg = JParallelConfig(**kw), ParallelConfig(**kw)
    tkw = dict(warmup_steps=2, total_steps=10, grad_compression=comp)
    jtc = JTR.TrainConfig(adam=JA.AdamWConfig(state_dtype=sd), **tkw)
    tc = TR.TrainConfig(adam=A.AdamWConfig(state_dtype=sd), **tkw)
    state = TR.init_state(tcfg, pcfg, tc, torch.Generator().manual_seed(0),
                          device="cpu")
    # copies: jnp.asarray would alias the numpy view of a tensor that the
    # port's step then updates in place, under the reference's async run
    jparams = jax.tree.map(lambda v: jnp.asarray(n(v).copy()),
                           state["params"])
    jshapes, _ = JT.abstract_params(jcfg, jpcfg)
    assert jax.tree.structure(jparams) == jax.tree.structure(jshapes)
    assert [(v.shape, v.dtype) for v in jax.tree.leaves(jparams)] == [
        (v.shape, v.dtype) for v in jax.tree.leaves(jshapes)]
    S_, B = SHAPE
    batch = D.make_batch(tcfg, ShapeConfig("t", S_, B, "train"), 0,
                         device="cpu")
    jbatch = {k: jnp.asarray(n(v)) for k, v in batch.items()}
    return (jcfg, jpcfg, jtc, jparams, jbatch), (tcfg, pcfg, tc, state, batch)


def _sorted_leaves(tree) -> list:
    """Leaves in ``jax.tree`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def _hold_grads(got, want) -> None:
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = _sorted_leaves(got)
    assert len(flat_g) == len(flat_w)
    for g, (path, w) in zip(flat_g, flat_w):
        w = np.asarray(w, np.float64)
        err = float(np.abs(n(g).astype(np.float64) - w).max())
        scale = max(float(np.abs(w).max()), 1e-30)
        assert err <= 1e-4 * scale, (jax.tree_util.keystr(path), err, scale)


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: f"{c[0]}-mb{c[1]}"
                         f"-{c[2]}-{c[3] or 'exact'}-{c[4]}")
def test_loss_grads_and_train_step_match_reference(case):
    (jcfg, jpcfg, jtc, jparams, jbatch), (tcfg, pcfg, tc, state, batch) = \
        _step_setup(*case)
    # the reference's value_and_grad of make_loss_fn on the whole batch and
    # its whole train step, under one jit (one compile, the forward shared)
    jvg = jax.value_and_grad(JTR.make_loss_fn(jcfg, jpcfg, jtc), has_aux=True)
    jstep = JTR.make_train_step(jcfg, jpcfg, jtc)
    jstate = {"params": jparams, "opt": JA.adamw_init(jparams, jtc.adam)}
    if tc.grad_compression:
        jstate["ef"] = jax.tree.map(lambda p: jnp.zeros(p.shape), jparams)
    ((jtot, (jloss, jaux, jmoem)), jgrads), (_, jm) = jax.jit(
        lambda st, b: (jvg(st["params"], b), jstep(st, b)))(jstate, jbatch)

    # make_loss_fn: value and grads on the whole batch
    (tot, (loss, aux, moem)), grads = TR.value_and_grad(
        TR.make_loss_fn(tcfg, pcfg, tc), state["params"], batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tot), float(jtot), rtol=1e-5)
    _hold_grads(grads, jgrads)
    assert sorted(moem) == sorted(jmoem)

    # one whole train step (microbatches, remat, compression as the case)
    new_state, m = TR.make_train_step(tcfg, pcfg, tc)(state, batch)
    assert new_state["params"] is state["params"]
    assert sorted(m) == sorted(jm)
    if tcfg.moe is not None:
        assert {"moe_drop_rate", "moe_load_imbalance"} <= set(m)
    for k, w in jm.items():
        assert isinstance(m[k], torch.Tensor) and m[k].device.type == "cpu"
        np.testing.assert_allclose(n(m[k]), np.asarray(w), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert int(new_state["opt"]["step"]) == 1
    if tc.grad_compression:
        assert sorted(new_state) == ["ef", "opt", "params"]


def test_microbatches_and_remat_leave_grads_unchanged():
    """The port against itself: microbatches 2 and remat full give the
    loss and grads of one whole-batch, no-remat pass (to f32 rounding).
    ``aux_weight`` is 0: a microbatch's load-balance loss is not a share of
    the whole batch's, so only the cross-entropy splits exactly; at
    capacity factor E / k no lane is dropped in either split."""
    arch = "deepseek-v2-lite-16b"
    cfg = dataclasses.replace(smoke_config(arch), dtype=torch.float32)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="iru_hash",
        capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    tc = TR.TrainConfig(aux_weight=0.0)
    params, _ = T.init_params(cfg, ParallelConfig(), torch.Generator()
                              .manual_seed(0), device="cpu")
    batch = D.make_batch(cfg, ShapeConfig("t", 32, 4, "train"), 1,
                         device="cpu")
    runs = {}
    for remat, mb in (("none", 1), ("full", 1), ("none", 2), ("full", 2)):
        pcfg = ParallelConfig(remat=remat, microbatches=mb, attn_chunk=16)
        runs[remat, mb] = TR.make_grad_fn(cfg, pcfg, tc)(params, batch)
    base_grads, base_loss = runs["none", 1][:2]
    for key, (grads, loss, aux, moem) in runs.items():
        assert float(loss) == pytest.approx(float(base_loss), rel=1e-6), key
        assert float(moem["moe_drop_rate"].max()) == 0.0
        for g, w in zip(tree_leaves(grads), tree_leaves(base_grads)):
            assert float((g - w).abs().max()) <= 1e-5 * float(
                w.abs().max()) + 1e-30, key

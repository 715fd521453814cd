"""Port parity: LM serving (``repro_torch.serve.engine``,
``repro_torch.launch.serve``) against ``repro.serve`` and
``repro.launch.serve``.

Both packages run one set of params: the port's ``init_params`` (a seeded
CPU generator) handed to the reference as numpy, after checking that the
tree equals the reference's.  Everything runs in f32 at smoke width; MoE
models take ``capacity_factor = n_experts / top_k``, so no lane is dropped
and a token's route does not depend on its batch.  The reference's engine
jits a new decode lambda per instance, so each reference engine is built
once a module (``_served``).  Tokens, ``done``, request ids and final
positions are held exactly; caches within ``TOL = 1e-5`` of the
reference's largest magnitude.
"""
from __future__ import annotations

import dataclasses
import re
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as j_launch
import repro.serve as jserve
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ParallelConfig as JParallelConfig
from repro.models import transformer as JT
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.launch import serve as t_launch
from repro_torch.models import transformer as T
from repro_torch.models.measure import tree_leaves
from repro_torch.serve import Request, ServeConfig, ServingEngine
from torch_parity import n

TOL = 1e-5
PCFG = ParallelConfig(model_axis=1, remat="none", attn_chunk=32)
JPCFG = JParallelConfig(model_axis=1, remat="none", attn_chunk=32)
ARCHS = ("qwen3-32b", "deepseek-v2-lite-16b", "mamba2-130m")
SC = dict(batch_slots=3, max_seq=32)
EOS_AT = 2  # the request that carries an eos_id


def _no_drop(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


_MODELS: dict = {}


def _model(arch):
    """(reference cfg, port cfg, reference params, port params), f32 at
    smoke width, one set of values (the port's draws)."""
    if arch not in _MODELS:
        jcfg = _no_drop(dataclasses.replace(j_smoke_config(arch),
                                            dtype=jnp.float32))
        tcfg = _no_drop(dataclasses.replace(smoke_config(arch),
                                            dtype=torch.float32))
        tparams, _ = T.init_params(tcfg, PCFG,
                                   torch.Generator().manual_seed(0),
                                   device="cpu")
        jshapes, _ = JT.abstract_params(jcfg, JPCFG)
        jparams = jax.tree.map(lambda v: jnp.asarray(n(v).copy()), tparams)
        assert jax.tree.structure(jparams) == jax.tree.structure(jshapes)
        assert [(v.shape, v.dtype) for v in jax.tree.leaves(jparams)] == [
            (v.shape, v.dtype) for v in jax.tree.leaves(jshapes)]
        _MODELS[arch] = (jcfg, tcfg, jparams, tparams)
    return _MODELS[arch]


def _request_set(vocab: int, eos_id=None):
    """(prompt, max_new_tokens, eos_id): seven requests for three slots,
    prompts of 1-6 tokens, 2-5 new tokens, one eos_id."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(7):
        prompt = rng.integers(0, vocab, int(rng.integers(1, 7))).astype(
            np.int32)
        out.append((prompt, 2 + i % 4, eos_id if i == EOS_AT else None))
    return out


def _serve(engine, request_cls, spec):
    reqs = [request_cls(prompt=p.copy(), max_new_tokens=m, eos_id=e)
            for p, m, e in spec]
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion()
    return reqs


_SERVED: dict = {}


def _served(arch):
    """Both engines after serving the same request set; the eos_id is the
    EOS request's first token in an eos-free run of the port, so it
    retires after one token."""
    if arch not in _SERVED:
        jcfg, tcfg, jp, tp = _model(arch)
        dry = _serve(ServingEngine(tcfg, PCFG, tp, ServeConfig(**SC),
                                   device="cpu"),
                     Request, _request_set(tcfg.vocab_size))
        spec = _request_set(tcfg.vocab_size, eos_id=dry[EOS_AT].generated[0])
        teng = ServingEngine(tcfg, PCFG, tp, ServeConfig(**SC), device="cpu")
        jeng = jserve.ServingEngine(jcfg, JPCFG, jp, jserve.ServeConfig(**SC))
        _SERVED[arch] = (teng, _serve(teng, Request, spec),
                         jeng, _serve(jeng, jserve.Request, spec), spec)
    return _SERVED[arch]


def _close(got, want, what):
    got, want = n(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max err {err:.3e} vs {TOL} x {scale:.3e}"


# ---------------------------------------------------------------------------
# (1) parity with the reference's engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch):
    teng, treqs, jeng, jreqs, spec = _served(arch)
    assert [r.rid for r in treqs] == [r.rid for r in jreqs] == list(range(7))
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [r.done for r in treqs] == [r.done for r in jreqs] == [True] * 7
    assert np.array_equal(teng.pos, jeng.pos)
    assert teng.active == [None] * 3 and not teng.queue
    # every request ran to its budget but the EOS one, which stopped at once
    for r, (_, m, e) in zip(treqs, spec):
        assert len(r.generated) == (1 if e is not None else m)
    tl, jl = jax.tree.leaves(teng.cache), jax.tree.leaves(jeng.cache)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        _close(a, b, f"{arch} cache")


def test_cache_is_updated_in_place():
    _, cfg, _, tp = _model("qwen3-32b")
    eng = ServingEngine(cfg, PCFG, tp, ServeConfig(**SC), device="cpu")
    before = [id(x) for x in tree_leaves(eng.cache)]
    eng.submit(Request(prompt=np.array([1, 2, 3], np.int32), max_new_tokens=2))
    eng.run_to_completion()
    assert [id(x) for x in tree_leaves(eng.cache)] == before
    assert any(bool(x.any()) for x in tree_leaves(eng.cache))


def test_request_and_config_fields_match_reference():
    for ours, theirs in ((Request, jserve.Request),
                         (ServeConfig, jserve.ServeConfig)):
        assert ([(f.name, f.default) for f in dataclasses.fields(ours)]
                == [(f.name, f.default) for f in dataclasses.fields(theirs)])


# ---------------------------------------------------------------------------
# (2) the reference's own engine tests (tests/test_serving.py), on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    cfg = dataclasses.replace(smoke_config("qwen3-32b"), dtype=torch.float32)
    params, _ = T.init_params(cfg, PCFG, torch.Generator().manual_seed(0),
                              device="cpu")
    return lambda **sc: ServingEngine(cfg, PCFG, params, ServeConfig(**sc),
                                      device="cpu")


def test_more_requests_than_slots_all_complete(qwen):
    eng = qwen(batch_slots=3, max_seq=64)
    reqs = [Request(prompt=np.array([1, 2, 3 + i]), max_new_tokens=4 + i % 3)
            for i in range(8)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    for i, r in enumerate(reqs):
        assert len(r.generated) == 4 + i % 3


def test_continuous_batching_matches_isolated_decode(qwen):
    """A request decoded alongside others produces the same tokens as alone."""
    prompt = np.array([5, 9, 2, 7])
    solo = Request(prompt=prompt.copy(), max_new_tokens=6)
    eng1 = qwen(batch_slots=1, max_seq=64)
    eng1.submit(solo)
    eng1.run_to_completion()

    crowd = [Request(prompt=np.array([1, 2, 3]), max_new_tokens=8) for _ in range(3)]
    shared = Request(prompt=prompt.copy(), max_new_tokens=6)
    eng2 = qwen(batch_slots=4, max_seq=64)
    for r in crowd:
        eng2.submit(r)
    eng2.submit(shared)
    eng2.run_to_completion()
    assert shared.generated == solo.generated


def test_eos_frees_slot_early(qwen):
    eng = qwen(batch_slots=1, max_seq=64)
    probe = Request(prompt=np.array([1, 2]), max_new_tokens=2)
    eng.submit(probe)
    eng.run_to_completion()
    eos = probe.generated[0]
    r2 = Request(prompt=np.array([1, 2]), max_new_tokens=50, eos_id=eos)
    eng.submit(r2)
    eng.run_to_completion()
    assert r2.done and len(r2.generated) == 1
    r3 = Request(prompt=np.array([3]), max_new_tokens=2)
    eng.submit(r3)
    eng.run_to_completion()
    assert r3.done and len(r3.generated) == 2


def test_run_to_completion_timeout_names_stuck_requests(qwen):
    eng = qwen(batch_slots=2, max_seq=64)
    ra = Request(prompt=np.array([1, 2]), max_new_tokens=50)
    rb = Request(prompt=np.array([3, 4]), max_new_tokens=50)
    eng.submit(ra)
    eng.submit(rb)
    with pytest.raises(TimeoutError, match=r"rids=\[0, 1\]"):
        eng.run_to_completion(max_ticks=3)
    assert not ra.done and not rb.done


def test_max_seq_retires_a_request_at_the_cache_end(qwen):
    """The third retire rule: a slot at ``max_seq - 1`` stops, whatever
    its budget."""
    eng = qwen(batch_slots=2, max_seq=8)
    r = Request(prompt=np.array([1, 2, 3]), max_new_tokens=50)
    eng.submit(r)
    eng.run_to_completion()
    assert r.done and len(r.generated) == 8 - 3


def test_params_on_another_device_are_refused():
    cfg = smoke_config("qwen3-32b")
    params, _ = T.abstract_params(cfg, PCFG)   # on `meta`
    with pytest.raises(ValueError, match="params on meta"):
        ServingEngine(cfg, PCFG, params, device="cpu")


# ---------------------------------------------------------------------------
# (3) the reference's SSM caveat, pinned
# ---------------------------------------------------------------------------

def _ssm_after_admission(eng, request_cls, cache_of):
    """Slot 0's Mamba state before and after a request is admitted into
    slot 1 (``tick``'s admission, called directly)."""
    eng.submit(request_cls(prompt=np.array([3, 1, 4], np.int32),
                           max_new_tokens=4))
    eng.tick()
    before = cache_of(eng)
    late = request_cls(prompt=np.array([2, 7, 1, 8], np.int32),
                       max_new_tokens=4)
    eng.submit(late)
    eng.queue.pop(0)
    eng.active[1], eng.pos[1] = late, 0
    eng._admit(1, late)
    return before, cache_of(eng)


def test_mamba_admission_moves_other_slots_state_in_both_packages():
    """A Mamba-2 decode step advances every row's recurrent state: an
    admission's replay into slot 1 moves active slot 0's ``ssm`` and
    ``conv`` state, in the reference and in the port alike."""
    jcfg, tcfg, jp, tp = _model("mamba2-130m")
    sc = dict(batch_slots=2, max_seq=16)
    teng = ServingEngine(tcfg, PCFG, tp, ServeConfig(**sc), device="cpu")
    jeng = jserve.ServingEngine(jcfg, JPCFG, jp, jserve.ServeConfig(**sc))
    slot0 = lambda c: {k: np.array(n(v))[:, 0]  # noqa: E731
                       for k, v in c[0][0]["mamba"].items()}
    t0, t1 = _ssm_after_admission(teng, Request, lambda e: slot0(e.cache))
    j0, j1 = _ssm_after_admission(jeng, jserve.Request,
                                  lambda e: slot0(e.cache))
    for k in ("ssm", "conv"):
        assert not np.allclose(t0[k], t1[k]), k
        assert not np.allclose(j0[k], j1[k]), k
        _close(t0[k], j0[k], f"{k} before")
        _close(t1[k], j1[k], f"{k} after")
    assert np.array_equal(teng.pos, jeng.pos)


# ---------------------------------------------------------------------------
# (4) the launcher
# ---------------------------------------------------------------------------

SUMMARY = re.compile(r"^served 5 requests / 15 tokens in \d+\.\ds "
                     r"\(\d+\.\d tok/s, 2 slots, continuous batching\)$")
LAUNCH = ["--smoke", "--requests", "5", "--slots", "2", "--max-new", "3",
          "--seed", "3"]


def test_launcher_serves_the_reference_launcher_s_prompts(monkeypatch,
                                                          capsys):
    reqs = t_launch.main(["--device", "cpu"] + LAUNCH)
    ours = capsys.readouterr().out.strip().splitlines()
    assert SUMMARY.match(ours[-1]), ours
    assert all(r.done and len(r.generated) == 3 for r in reqs)

    # the reference launcher, its weights and engine replaced by a recorder
    seen = []

    class Recorder:
        def __init__(self, *a, **kw):
            pass

        def submit(self, r):
            seen.append(r)

        def run_to_completion(self):
            time.sleep(1e-3)
            for r in seen:
                r.generated, r.done = [0] * r.max_new_tokens, True

    monkeypatch.setattr(j_launch.tfm, "init_params",
                        lambda *a, **kw: (None, None))
    monkeypatch.setattr(j_launch, "ServingEngine", Recorder)
    monkeypatch.setattr(sys, "argv", ["serve"] + LAUNCH)
    j_launch.main()
    theirs = capsys.readouterr().out.strip().splitlines()
    assert SUMMARY.match(theirs[-1]), theirs
    assert len(seen) == len(reqs) == 5
    for a, b in zip(reqs, seen):
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        assert np.array_equal(a.prompt, b.prompt)
        assert a.max_new_tokens == b.max_new_tokens == 3

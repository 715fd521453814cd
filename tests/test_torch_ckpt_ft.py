"""Port parity: checkpoints (``repro_torch.ckpt``), the training supervisor
and its fault plans (``repro_torch.ft``) and the training launcher
(``repro_torch.launch.train``), against ``repro.ckpt`` and the reference's
own substrate tests (``tests/test_substrate.py``).

The checkpoint format is the reference's: a state saved by either package
restores in the other bit for bit, and both write the same manifest for the
same state.  The supervisor tests are the reference's, run on the port's
train step on the CPU, where replay after a crash is exact.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as j_restore
from repro.ckpt import save_checkpoint as j_save
from repro_torch.ckpt import (CheckpointManager, latest_step,
                              restore_checkpoint, save_checkpoint)
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.convert import params_from_numpy
from repro_torch.data import make_batch
from repro_torch.ft import (FaultInjector, FaultPlan, Supervisor,
                            SupervisorConfig, WorkerDied)
from repro_torch.launch import train as launch_train
from repro_torch.models.measure import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.train import (TrainConfig, abstract_state, init_state,
                               make_train_step)

CFG = smoke_config("qwen3-32b")  # bf16, as the reference's tests
PCFG = ParallelConfig(model_axis=1, remat="none", attn_chunk=32)
SHAPE = ShapeConfig("t", 64, 4, "train")


def _tiny_state(state_dtype: str = "int8"):
    tc = TrainConfig(adam=AdamWConfig(state_dtype=state_dtype))
    return init_state(CFG, PCFG, tc, torch.Generator().manual_seed(0),
                      device="cpu"), tc


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        bits = t.detach().view(torch.int16).numpy().view(np.uint16)
        return jnp.asarray(bits.view(ml_dtypes.bfloat16).copy())
    return jnp.asarray(t.detach().numpy().copy())


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _by_name(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_by_name(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("state_dtype", ["bf16", "int8"])
def test_checkpoint_round_trip(state_dtype, tmp_path):
    state, tc = _tiny_state(state_dtype)
    save_checkpoint(str(tmp_path), 1, state)
    back = restore_checkpoint(str(tmp_path), abstract_state(CFG, PCFG, tc)[0],
                              device="cpu")
    want, got = _by_name(state), _by_name(back)
    assert sorted(got) == sorted(want)
    assert all(_same(got[k], want[k]) for k in want)
    assert got["opt/step"].shape == () and got["opt/step"].dtype == torch.int32


def test_checkpoint_crc_detects_corruption(tmp_path):
    state, _ = _tiny_state()
    path = save_checkpoint(str(tmp_path), 1, state)
    shard = os.path.join(path, "shard_00000.npz")
    data = bytearray(open(shard, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(shard, "wb").write(bytes(data))
    with pytest.raises(Exception):
        restore_checkpoint(str(tmp_path), state, device="cpu")


def test_latest_pointer_and_retention(tmp_path):
    state, _ = _tiny_state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state, blocking=True)
    assert latest_step(str(tmp_path)) == 4
    assert sorted(x for x in os.listdir(tmp_path) if x.startswith("step_")) \
        == ["step_00000003", "step_00000004"]
    assert not [x for x in os.listdir(tmp_path) if ".tmp." in x]


def test_restore_casts_to_the_target_dtype(tmp_path):
    save_checkpoint(str(tmp_path), 1,
                    {"w": torch.full((8, 8), 1.5, dtype=torch.bfloat16)})
    back = restore_checkpoint(str(tmp_path),
                              {"w": torch.empty(8, 8, device="meta")},
                              device="cpu")
    assert back["w"].dtype == torch.float32
    assert torch.equal(back["w"], torch.full((8, 8), 1.5))


def test_non_blocking_save_snapshots_before_returning(tmp_path):
    """The train step updates in place: a save that returned must already
    hold the pre-update values."""
    state, _ = _tiny_state("fp32")
    before = {k: v.detach().clone() for k, v in _by_name(state).items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, state, blocking=False)
    with torch.no_grad():
        for v in tree_leaves(state):
            v.add_(1)
    mgr.wait()
    back = _by_name(restore_checkpoint(str(tmp_path), state, device="cpu"))
    assert all(_same(back[k], before[k]) for k in before)


def test_checkpoints_cross_packages_bit_for_bit(tmp_path):
    """A TrainState (bf16 params, int8 moment dicts, the 0-d int32 step)
    saved by the reference restores in the port, and the port's restores
    in the reference; both write the same manifest for it."""
    state, tc = _tiny_state("int8")
    jstate = jax.tree.map(_to_jax, state)
    # the reference's TrainState crosses whole through params_from_numpy
    carried = _by_name(params_from_numpy(jstate, "cpu"))
    want = _by_name(state)
    assert all(_same(carried[k], want[k]) for k in want)

    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    j_save(jdir, 3, jstate)
    save_checkpoint(tdir, 3, state)
    manifests = [json.load(open(os.path.join(d, "step_00000003",
                                             "manifest.json")))
                 for d in (jdir, tdir)]
    assert manifests[0] == manifests[1]

    got = _by_name(restore_checkpoint(jdir, abstract_state(CFG, PCFG, tc)[0],
                                      device="cpu"))
    assert all(_same(got[k], want[k]) for k in want)
    target = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                          jstate)
    back = j_restore(tdir, target)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                jax.tree_util.tree_flatten_with_path(jstate)[0]):
        assert pa == pb and a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), pa


# ---------------------------------------------------------------------------
# Supervisor / fault tolerance (tests/test_substrate.py:194-250, ported)
# ---------------------------------------------------------------------------


def _batch_fn(s):
    return make_batch(CFG, SHAPE, s, device="cpu")


def _supervised_run(plan: FaultPlan, tmp_path, steps=12, ckpt_every=3):
    tc = TrainConfig(warmup_steps=1, total_steps=steps)
    state = init_state(CFG, PCFG, tc, torch.Generator().manual_seed(0),
                       device="cpu")
    sup = Supervisor(CheckpointManager(str(tmp_path)),
                     SupervisorConfig(ckpt_every=ckpt_every),
                     injector=FaultInjector(plan))
    state, last = sup.run(state, make_train_step(CFG, PCFG, tc), _batch_fn,
                          0, steps)
    return sup, last


def test_supervisor_survives_worker_death(tmp_path):
    sup, last = _supervised_run(FaultPlan(die_at=(5,)), tmp_path)
    assert last == 12 and sup.restarts == 1
    assert sup.injector.fired == {("die", 5)}


def test_supervisor_quarantines_nan(tmp_path):
    sup, last = _supervised_run(FaultPlan(nan_at=(7,)), tmp_path)
    assert last == 12 and sup.nan_events == 1
    assert all(np.isfinite(h["loss"]) for h in sup.history)


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    plan = FaultPlan(die_at=tuple(range(1, 40)))
    tc = TrainConfig(warmup_steps=1, total_steps=10)
    state = init_state(CFG, PCFG, tc, torch.Generator().manual_seed(0),
                       device="cpu")

    class Relentless(FaultInjector):  # every step dies, every time
        def before_step(self, step):
            self.fired.clear()
            super().before_step(step)

    sup = Supervisor(CheckpointManager(str(tmp_path)),
                     SupervisorConfig(max_restarts=2),
                     injector=Relentless(plan))
    with pytest.raises(WorkerDied):
        sup.run(state, make_train_step(CFG, PCFG, tc), _batch_fn, 0, 10)
    assert sup.restarts == 3


def test_training_resumes_identically_after_crash(tmp_path):
    """Crash + restore + replay gives the uninterrupted loss trajectory,
    exactly on the CPU, and the last checkpoint holds the final state."""
    tc = TrainConfig(warmup_steps=1, total_steps=10)
    step_fn = make_train_step(CFG, PCFG, tc)
    st = init_state(CFG, PCFG, tc, torch.Generator().manual_seed(0),
                    device="cpu")
    base = []
    for s in range(8):
        st, m = step_fn(st, _batch_fn(s))
        base.append(float(m["loss"]))

    sup = Supervisor(CheckpointManager(str(tmp_path)),
                     SupervisorConfig(ckpt_every=4),
                     injector=FaultInjector(FaultPlan(die_at=(6,))))
    st2 = init_state(CFG, PCFG, tc, torch.Generator().manual_seed(0),
                     device="cpu")
    st2, last = sup.run(st2, step_fn, _batch_fn, 0, 8)
    assert last == 8 and sup.restarts == 1
    by_step = {h["step"]: h["loss"] for h in sup.history}  # replays overwrite
    assert [by_step[s] for s in range(8)] == base
    assert [h["step"] for h in sup.history] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
    saved = _by_name(restore_checkpoint(str(tmp_path), st2, device="cpu"))
    assert all(_same(saved[k], v) for k, v in _by_name(st).items())


@pytest.mark.parametrize("field, bad", [("die_at", (-1,)), ("hang_at", (2, -3)),
                                        ("nan_at", (-2,)),
                                        ("hang_seconds", -0.1)])
def test_fault_plan_rejects_negative_entries(field, bad):
    with pytest.raises(ValueError):
        FaultPlan(**{field: bad})


def test_fault_injector_fires_each_entry_once():
    inj = FaultInjector(FaultPlan(die_at=(2,), nan_at=(3,), hang_at=(1,),
                                  hang_seconds=0.0))
    inj.before_step(1)
    with pytest.raises(WorkerDied):
        inj.before_step(2)
    inj.before_step(2)  # a replayed step survives
    assert np.isnan(inj.poison_loss(3, 1.0)) and inj.poison_loss(3, 1.0) == 1.0
    assert inj.fired == {("hang", 1), ("die", 2), ("nan", 3)}


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------


def test_launcher_runs_on_the_cpu_with_injected_faults(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    argv = ["--device", "cpu", "--smoke", "--steps", "6", "--batch", "2",
            "--seq", "32", "--ckpt", ckpt, "--ckpt-every", "2",
            "--inject-faults", "--log-every", "1"]
    launch_train.main(argv)
    out = capsys.readouterr().out
    with open(os.path.join(ckpt, "train_summary.json")) as f:
        summary = json.load(f)
    assert summary == {"arch": "mamba2-130m", "steps": 6, "restarts": 1,
                       "nan_events": 1}
    assert "step     5 loss" in out and "device=cpu" in out
    assert latest_step(ckpt) == 6
    # a second launch resumes from LATEST and has nothing left to run
    launch_train.main(argv)
    assert "resuming from checkpoint step 6" in capsys.readouterr().out


def test_launcher_moe_dispatch_needs_a_moe_arch(tmp_path):
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--smoke", "--arch",
                           "qwen3-32b", "--moe-dispatch", "iru_hash",
                           "--ckpt", str(tmp_path)])


def test_abstract_state_is_meta_and_matches_init():
    tc = TrainConfig(adam=AdamWConfig(state_dtype="int8"),
                     grad_compression="int8_ef")
    meta, specs = abstract_state(CFG, PCFG, tc)
    real = init_state(CFG, PCFG, tc, torch.Generator().manual_seed(0),
                      device="cpu")
    m, r = _by_name(meta), _by_name(real)
    assert sorted(m) == sorted(r)
    for k in r:
        assert m[k].device.type == "meta"
        assert (m[k].shape, m[k].dtype) == (r[k].shape, r[k].dtype), k
    assert all(p.requires_grad for p in tree_leaves(real["params"]))
    assert "ef" in real and "ef" in meta

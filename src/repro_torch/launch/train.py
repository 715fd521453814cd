"""End-to-end training launcher (counterpart of ``repro.launch.train``).

Trains a registry architecture on the seeded Zipf stream under the
fault-tolerant supervisor, on the card unless ``--device`` says otherwise:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch mamba2-130m --steps 300 --batch 8 --seq 256 --ckpt /tmp/ckpt

It resumes from ``--ckpt``'s ``LATEST`` when there is one, prints a log
line every ``--log-every`` steps and writes ``train_summary.json`` beside
the checkpoints.  The default ``--ckpt`` differs from the JAX package's
(``/tmp/repro_ckpt``), so the two never resume from each other's run by
accident; the format is the same, so one can be pointed at the other's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.ckpt import CheckpointManager, latest_step
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device
from repro_torch.ft import FaultInjector, FaultPlan, Supervisor, SupervisorConfig
from repro_torch.models.measure import tree_leaves
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import (TrainConfig, abstract_state,
                                       init_state, make_train_step)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--opt-dtype", choices=["fp32", "bf16", "int8"],
                    default="fp32")
    ap.add_argument("--compress", action="store_true",
                    help="int8+EF grad compression")
    ap.add_argument("--ckpt", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-faults", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--moe-dispatch", choices=["iru_sorted", "iru_hash",
                                               "dense"], default=None,
                    help="override MoEConfig.dispatch (MoE archs only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


class _LoggedHistory(list):
    """The supervisor's history, printing every ``log_every``-th record."""

    def __init__(self, log_every: int):
        super().__init__()
        self.log_every = log_every
        self.t0 = time.monotonic()

    def append(self, rec: dict) -> None:
        super().append(rec)
        if rec["step"] % self.log_every:
            return
        extra = ""
        dr = rec.get("moe_drop_rate")
        if dr is not None and len(dr):
            # per-layer drop rates from the planned dispatch's stats
            # (moe_load_imbalance rides alongside in the history)
            extra = (f" moe_drop {float(dr.mean()):.3f}"
                     f"/max {float(dr.max()):.3f}")
        print(f"step {rec['step']:5d} loss {rec['loss']:.4f} "
              f"({rec['dt'] * 1e3:.0f} ms/step, "
              f"{time.monotonic() - self.t0:.0f}s total){extra}", flush=True)


def main(argv: list[str] | None = None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.moe_dispatch is not None:
        if cfg.moe is None:
            ap.error(f"--moe-dispatch set but arch {cfg.name!r} has no MoE "
                     f"layers")
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=args.moe_dispatch))
    pcfg = ParallelConfig(model_axis=1, remat="full",
                          microbatches=args.microbatches,
                          attn_chunk=min(256, args.seq))
    tc = TrainConfig(
        adam=AdamWConfig(lr=args.lr, state_dtype=args.opt_dtype),
        warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps,
        grad_compression="int8_ef" if args.compress else None,
    )
    shape = ShapeConfig("cli", args.seq, args.batch, "train")

    mgr = CheckpointManager(args.ckpt, keep=3)
    start = latest_step(args.ckpt) or 0
    if start:
        print(f"resuming from checkpoint step {start}")
        state = mgr.restore_latest(abstract_state(cfg, pcfg, tc)[0],
                                   device=dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        state = init_state(cfg, pcfg, tc, gen, dev)
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"opt={args.opt_dtype} steps={args.steps} "
          f"batch={args.batch}x{args.seq} device={dev}")

    step_fn = make_train_step(cfg, pcfg, tc)
    injector = (FaultInjector(FaultPlan(die_at=(args.steps // 3,),
                                        nan_at=(2 * args.steps // 3,)))
                if args.inject_faults else None)
    sup = Supervisor(mgr, SupervisorConfig(ckpt_every=args.ckpt_every),
                     injector=injector, history=_LoggedHistory(args.log_every))
    state, last = sup.run(state, step_fn,
                          lambda s: make_batch(cfg, shape, s, device=dev),
                          start, args.steps - start)
    mgr.wait()
    print(f"done at step {last}; restarts={sup.restarts} "
          f"straggles={sup.straggles} nan_events={sup.nan_events}")
    with open(os.path.join(args.ckpt, "train_summary.json"), "w") as f:
        json.dump({"arch": cfg.name, "steps": last, "restarts": sup.restarts,
                   "nan_events": sup.nan_events}, f)


if __name__ == "__main__":
    main()

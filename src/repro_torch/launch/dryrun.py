"""Multi-pod dry run: count every (arch x shape x mesh) cell on ``meta``
(counterpart of ``repro.launch.dryrun``).

For each cell this driver builds the full program -- ``train_step`` (model
+ loss + AdamW) for training shapes, ``prefill`` for prefill shapes, and
``decode_step`` (one token against a full KV cache) for decode shapes --
with the production mesh's shardings, runs it once on the ``meta`` device
under ``launch.hlo_stats.count_step``, and records:

  * ``memory_analysis``  (per-device argument bytes, from each argument's
    ``shard_shape``)
  * ``cost_analysis``    (FLOPs and bytes per device: the counted step split
    evenly over the mesh's devices; the global counts beside them)
  * the derived roofline on the H100's data-sheet constants (compute and
    memory; the port issues no collective, so that term is null)

Every tensor lives on ``meta``: the dry run allocates nothing, needs no
card, and is the one entry point of the port that touches no device (the
reference forces 512 host devices; the port's production mesh is
abstract).  Records go to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``
so a crashed sweep resumes where it stopped.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both          # full sweep
    python -m repro_torch.launch.dryrun --all --subprocess          # isolation
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Callable, Optional

import torch

from repro_torch.configs import (ARCH_IDS, LM_SHAPES, get_config,
                                 shape_applicable)
from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.data.pipeline import batch_specs
from repro_torch.dist.sharding import NamedSharding, use_mesh
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shardings import (default_pcfg, shard_tree,
                                          state_shardings)
from repro_torch.models import transformer as tfm
from repro_torch.models.measure import measure_mode
from repro_torch.train.trainer import (TrainConfig, abstract_state,
                                       make_train_step)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
HBM_GB = 80.0  # the H100's memory, 80 GB (80e9 bytes) a card


def _result_path(arch: str, shape: str, mesh_name: str) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    return os.path.join(RESULTS_DIR, f"{arch}__{shape}__{mesh_name}.json")


# ---------------------------------------------------------------------------
# Cell lowering: the step and its meta arguments with their shardings
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Lowered:
    fn: Callable
    args: tuple
    in_shardings: tuple   # per argument: a tree of NamedShardings, or None

    def argument_bytes(self) -> int:
        """Bytes of the arguments one device of the mesh holds."""
        return sum(_shard_bytes(a, s)
                   for a, s in zip(self.args, self.in_shardings))


def _shard_bytes(arg, sharding) -> int:
    if isinstance(arg, torch.Tensor):
        shape = (arg.shape if sharding is None
                 else sharding.shard_shape(tuple(arg.shape)))
        n = 1
        for d in shape:
            n *= d
        return n * arg.element_size()
    if isinstance(arg, dict):
        return sum(_shard_bytes(v, None if sharding is None else sharding[k])
                   for k, v in arg.items())
    if isinstance(arg, (list, tuple)):
        return sum(_shard_bytes(v, None if sharding is None else s)
                   for v, s in zip(arg, sharding or [None] * len(arg)))
    if isinstance(sharding, NamedSharding):
        raise TypeError(f"sharding {sharding} for a non-tensor {arg!r}")
    return 0


def lower_train(cfg: ModelConfig, pcfg: ParallelConfig, shape: ShapeConfig,
                mesh, tc: TrainConfig = TrainConfig()) -> Lowered:
    state_shapes, param_specs = abstract_state(cfg, pcfg, tc)
    st_sh = state_shardings(state_shapes, param_specs, mesh,
                            fsdp_params=pcfg.fsdp_params)
    b_shapes, b_axes = batch_specs(cfg, shape)
    b_sh = shard_tree(b_shapes, b_axes, mesh)
    step = make_train_step(cfg, pcfg, tc)
    return Lowered(step, (state_shapes, b_shapes), (st_sh, b_sh))


def lower_prefill(cfg: ModelConfig, pcfg: ParallelConfig, shape: ShapeConfig,
                  mesh) -> Lowered:
    params_shapes, param_specs = tfm.abstract_params(cfg, pcfg)
    p_sh = shard_tree(params_shapes, param_specs, mesh, zero=pcfg.fsdp_params)
    b_shapes, b_axes = batch_specs(cfg, shape)
    b_shapes.pop("labels", None)
    b_axes.pop("labels", None)
    b_sh = shard_tree(b_shapes, b_axes, mesh)
    cache_shapes = tfm.init_cache(cfg, pcfg, shape.global_batch,
                                  shape.seq_len, abstract=True)
    c_sh = shard_tree(cache_shapes, tfm.cache_axes(cfg, pcfg), mesh)

    @torch.no_grad()
    def fn(params, batch, cache):
        return tfm.prefill(params, cfg, pcfg, batch, cache)

    return Lowered(fn, (params_shapes, b_shapes, cache_shapes),
                   (p_sh, b_sh, c_sh))


def lower_decode(cfg: ModelConfig, pcfg: ParallelConfig, shape: ShapeConfig,
                 mesh) -> Lowered:
    params_shapes, param_specs = tfm.abstract_params(cfg, pcfg)
    p_sh = shard_tree(params_shapes, param_specs, mesh, zero=pcfg.fsdp_params)
    B = shape.global_batch
    cache_shapes = tfm.init_cache(cfg, pcfg, B, shape.seq_len, abstract=True)
    c_sh = shard_tree(cache_shapes, tfm.cache_axes(cfg, pcfg), mesh)
    tok = torch.empty((B, 1), dtype=torch.int32, device="meta")
    tok_sh = shard_tree(tok, ("batch", "seq"), mesh)
    pos = torch.empty((), dtype=torch.int32, device="meta")

    @torch.no_grad()
    def fn(params, tokens, cache, pos):
        return tfm.decode_step(params, cfg, pcfg, tokens, cache, pos)

    return Lowered(fn, (params_shapes, tok, cache_shapes, pos),
                   (p_sh, tok_sh, c_sh, None))


LOWERERS = {"train": lower_train, "prefill": lower_prefill,
            "decode": lower_decode}


# ---------------------------------------------------------------------------
# Stage-depth extrapolation
#
# The reference extrapolates because XLA's cost analysis visits a while-loop
# body once.  The port's count sees every iteration, so a full-depth count
# would be exact too, but it costs host time in proportion to depth (the
# 88-layer archs); the dry run counts each cell at 1-unit and 2-unit stage
# depth (identical widths/shapes otherwise) and extrapolates every additive
# measurement linearly, as the reference does:
#
#     M(full) = M(1u) + (R-1) * [M(2u) - M(1u)]        per scanned stage
#
# This is exact for the counted FLOPs and bytes (additive per unit).  Raw
# per-variant measurements are kept in the record for audit.  A unit only
# adds ops, so a count that shrinks with depth is a counting fault: it
# raises, where the reference clamps the delta at zero and re-anchors on 2
# units against an SPMD strategy flip (an eager count cannot flip).
# ---------------------------------------------------------------------------

def _stage_geometry(cfg: ModelConfig):
    """(lead_layers, unit_len, dec_repeat, enc_repeat)."""
    lead = cfg.moe.first_dense_layers if cfg.moe else 0
    unit = 1 if lead else cfg.unit_len()
    rep = (cfg.n_layers - lead) // unit
    return lead, unit, rep, cfg.encoder_layers


def _variant(cfg: ModelConfig, dec_units: int, enc_layers: int) -> ModelConfig:
    lead, unit, _, enc = _stage_geometry(cfg)
    return dataclasses.replace(
        cfg,
        n_layers=lead + unit * dec_units,
        encoder_layers=enc_layers if enc else 0,
    )


def _measure(cfg_v: ModelConfig, pcfg: ParallelConfig, shape: ShapeConfig,
             mesh, n_dev: int) -> dict:
    # measure with microbatches=1: accumulation is linear, so k microbatches
    # give the same per-step FLOPs/bytes; activation-memory effects of
    # microbatching are covered by analytic_memory instead.
    pcfg = dataclasses.replace(pcfg, microbatches=1)
    t0 = time.monotonic()
    # use_mesh so the model's constrain calls resolve their specs
    with use_mesh(mesh), measure_mode():
        lowered = LOWERERS[shape.kind](cfg_v, pcfg, shape, mesh)
        t_lower = time.monotonic() - t0
        counts = hlo_stats.count_step(lowered.fn, *lowered.args)
        t_count = time.monotonic() - t0 - t_lower
    return {
        "flops": counts["flops"] / n_dev,
        "bytes_accessed": counts["bytes_accessed"] / n_dev,
        "flops_global": counts["flops"],
        "bytes_global": counts["bytes_accessed"],
        "memory_analysis": {
            "argument_size_in_bytes": lowered.argument_bytes()},
        "lower_s": round(t_lower, 2),
        "count_s": round(t_count, 2),
    }


_ADDITIVE = ("flops", "bytes_accessed", "flops_global", "bytes_global")


def _extrapolate(base: dict, delta_sets: list[tuple[int, dict]]) -> dict:
    """base + sum_s (rep_s - 1) * (two_s - base), per additive key."""
    out = {k: base[k] for k in _ADDITIVE}
    for rep, two in delta_sets:
        for k in _ADDITIVE:
            if two[k] < base[k]:
                raise ValueError(f"{k} shrinks with depth: {base[k]} at "
                                 f"the base, {two[k]} one unit deeper")
            out[k] += (rep - 1) * (two[k] - base[k])
    return out


# ---------------------------------------------------------------------------
# Cell execution
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             save: bool = True) -> dict:
    cfg = get_config(arch)
    shape = LM_SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "status": None,
    }
    if not ok:
        record.update(status="skipped", reason=why)
        if save:
            _save(record)
        return record
    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
    n_dev = mesh.size
    pcfg = default_pcfg(cfg, shape, mesh)
    record["pcfg"] = dataclasses.asdict(pcfg)
    lead, unit, dec_rep, enc_rep = _stage_geometry(cfg)
    try:
        base = _measure(_variant(cfg, 1, min(enc_rep, 1)), pcfg, shape, mesh,
                        n_dev)
        deltas: list[tuple[int, dict]] = []
        variants: dict = {"base_1unit": base}
        if dec_rep > 1:
            two = _measure(_variant(cfg, 2, min(enc_rep, 1)), pcfg, shape,
                           mesh, n_dev)
            variants["dec_2unit"] = two
            deltas.append((dec_rep, two))
        if enc_rep > 1:
            enc2 = _measure(_variant(cfg, 1, 2), pcfg, shape, mesh, n_dev)
            deltas.append((enc_rep, enc2))
            variants["enc_2layer"] = enc2
        full = _extrapolate(base, deltas)
    except Exception as e:  # noqa: BLE001 -- a failed cell is a recorded bug
        record.update(status="failed", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        if save:
            _save(record)
        return record

    roof = hlo_stats.Roofline(full["flops"], full["bytes_accessed"], None,
                              n_dev)
    mf = hlo_stats.model_flops(cfg, shape)
    record.update(
        status="ok",
        stage_geometry={"lead": lead, "unit": unit, "dec_repeat": dec_rep,
                        "enc_repeat": enc_rep},
        count_s=round(sum(v["count_s"] for v in variants.values()), 2),
        memory_analysis=base["memory_analysis"],
        cost_analysis={"flops": full["flops"],
                       "bytes_accessed": full["bytes_accessed"],
                       "flops_global": full["flops_global"],
                       "bytes_global": full["bytes_global"],
                       "transcendentals": None},
        collectives={"counts": None, "result_bytes": None,
                     "wire_bytes_per_device": None},
        roofline=roof.as_dict(),
        model_flops=mf,
        useful_flops_ratio=(mf / full["flops_global"]
                            if full["flops_global"] else None),
        analytic_memory=analytic_memory(cfg, pcfg, shape, n_dev),
        variants={k: {kk: vv for kk, vv in v.items()
                      if kk != "memory_analysis"}
                  for k, v in variants.items()},
    )
    if save:
        _save(record)
    return record


def analytic_memory(cfg: ModelConfig, pcfg: ParallelConfig, shape: ShapeConfig,
                    n_dev: int) -> dict:
    """HBM-fit estimate per device (the reference's structural estimate,
    held against the H100's 80 GB).

    Params are TP/DP-sharded across the whole mesh for weights (model axis)
    and ZeRO-fragments for optimizer moments (all axes)."""
    n_params = cfg.params_billions() * 1e9
    model_axis = pcfg.model_axis
    denom = n_dev if pcfg.fsdp_params else model_axis  # FSDP: whole mesh
    param_bytes = n_params * 2 / denom                 # bf16 weights
    record = {"param_bytes_per_dev": param_bytes, "fsdp": pcfg.fsdp_params}
    if shape.kind == "train":
        # fp32 m+v ZeRO-sharded over the full mesh
        record["opt_bytes_per_dev"] = n_params * 8 / n_dev
        toks_per_dev = shape.global_batch * shape.seq_len / (n_dev / model_axis)
        toks_per_dev /= max(pcfg.microbatches, 1)
        # remat keeps ~2 fp32 residences of (tokens, d_model) per layer-unit
        record["act_bytes_per_dev"] = toks_per_dev * cfg.d_model * 4 * 2
    else:
        # KV cache per device
        kv_per_tok = 0.0
        for kind in cfg.layer_kinds():
            if kind != "attn":
                continue
            if cfg.attention == "mla":
                kv_per_tok += (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
            else:
                kv_per_tok += 2 * cfg.n_kv_heads * cfg.head_dim * 2
        cache_global = kv_per_tok * shape.seq_len * shape.global_batch
        # batch shards over data; kv_seq falls through to the (otherwise
        # idle) model axis -> the cache divides by the whole mesh
        record["cache_bytes_per_dev"] = cache_global / n_dev
    record["total_per_dev_gb"] = round(sum(record.values()) / 2**30, 3)
    record["fits_80gb"] = record["total_per_dev_gb"] * 2**30 < HBM_GB * 1e9
    return record


def _save(record: dict) -> None:
    path = _result_path(record["arch"], record["shape"], record["mesh"])
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


# ---------------------------------------------------------------------------
# Sweep driver
# ---------------------------------------------------------------------------

def all_cells(mesh_names):
    for arch in ARCH_IDS:
        for shape in LM_SHAPES:
            for mesh_name in mesh_names:
                yield arch, shape, mesh_name


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(LM_SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--subprocess", action="store_true",
                    help="one subprocess per cell (memory isolation)")
    ap.add_argument("--force", action="store_true",
                    help="recompute cached cells")
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        cells = list(all_cells(meshes))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape, m) for m in meshes]

    failures = 0
    for arch, shape, mesh_name in cells:
        path = _result_path(arch, shape, mesh_name)
        if not args.force and os.path.exists(path):
            with open(path) as f:
                prev = json.load(f)
            if prev.get("status") in ("ok", "skipped"):
                print(f"[cached] {arch} {shape} {mesh_name}: {prev['status']}")
                continue
        if args.subprocess:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_name]
            if args.force:
                cmd.append("--force")
            try:
                rc = subprocess.run(cmd, timeout=2400).returncode
            except subprocess.TimeoutExpired:
                rc = -1
                _save({"arch": arch, "shape": shape, "mesh": mesh_name,
                       "kind": LM_SHAPES[shape].kind, "status": "failed",
                       "error": "count timeout (2400s)"})
                print(f"[TIMEOUT] {arch} {shape} {mesh_name}")
            if rc:
                failures += 1
            continue
        rec = run_cell(arch, shape, mesh_name)
        if rec["status"] == "ok":
            ra, ratio = rec["roofline"], rec["useful_flops_ratio"]
            print(f"[ok] {arch} {shape} {mesh_name}: count={rec['count_s']}s "
                  f"tc={ra['t_compute_s']:.3e} tm={ra['t_memory_s']:.3e} "
                  f"tx={ra['t_collective_s']} bound={ra['bottleneck']} "
                  f"useful={ratio and round(ratio, 3)}")
        elif rec["status"] == "skipped":
            print(f"[skip] {arch} {shape} {mesh_name}: {rec['reason']}")
        else:
            failures += 1
            print(f"[FAIL] {arch} {shape} {mesh_name}: {rec['error']}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

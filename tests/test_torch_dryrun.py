"""Port parity: the dry run (``repro_torch.launch.dryrun``) on the ``meta``
device, against the reference's helpers.

The stage geometry, the depth variants, the extrapolation and the analytic
memory estimate equal the reference's for every architecture.  On smoke
configs deepened so that a stage repeats four times, the counts
extrapolated from 1- and 2-unit variants equal a direct full-depth count
exactly; the counted FLOPs cover the step's matrix products; the byte
count moves only the rows an indexed write names; one full-size cell runs through ``run_cell`` and ``main`` into a
temporary results directory.  Nothing here allocates a tensor's storage.
"""
from __future__ import annotations

import dataclasses
import os

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import shardings as jshardings
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

ARCHS = jconfigs.ARCH_IDS


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module.  Importing it sets ``XLA_FLAGS`` (512
    host devices); JAX's backend is started first, so the flag reaches no
    client, and the variable is put back."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun


@pytest.mark.parametrize("arch", ARCHS)
def test_stage_geometry_variants_and_memory_match_reference(arch, ref_dryrun):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert D._stage_geometry(cfg) == ref_dryrun._stage_geometry(jcfg)
    for units, enc in ((1, 1), (2, 1), (3, 1), (1, 2), (1, 0)):
        got, want = D._variant(cfg, units, enc), ref_dryrun._variant(
            jcfg, units, enc)
        assert (got.n_layers, got.encoder_layers) == (want.n_layers,
                                                      want.encoder_layers)
        assert dataclasses.replace(got, n_layers=cfg.n_layers,
                                   encoder_layers=cfg.encoder_layers) == cfg
    for kind in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=kind == "multi")
        jmesh = jax.sharding.AbstractMesh(tuple(mesh.axis_sizes),
                                          tuple(mesh.axis_names))
        for name, shape in configs.LM_SHAPES.items():
            jshape = jconfigs.LM_SHAPES[name]
            pcfg = configs.ParallelConfig(**dataclasses.asdict(
                jshardings.default_pcfg(jcfg, jshape, jmesh)))
            got = D.analytic_memory(cfg, pcfg, shape, mesh.size)
            want = ref_dryrun.analytic_memory(jcfg, pcfg, jshape, mesh.size)
            assert got.pop("fits_80gb") == (
                want["total_per_dev_gb"] * 2**30 < 80e9)
            want.pop("fits_16gb")
            assert got == want


def test_extrapolate_matches_reference(ref_dryrun):
    def rec(f, b):
        return {"flops": f, "bytes_accessed": b, "flops_global": 4 * f,
                "bytes_global": 4 * b, "transcendentals": 0.0,
                "wire_bytes": 0.0, "coll_counts": {}, "coll_result_bytes": {}}

    base, two, enc2 = rec(10.0, 7.0), rec(16.0, 9.5), rec(13.0, 7.25)
    for deltas in ([], [(5, two)], [(5, two), (3, enc2)], [(2, base)]):
        got = D._extrapolate(base, deltas)
        want = ref_dryrun._extrapolate(base, deltas)
        assert {k: got[k] for k in ("flops", "bytes_accessed")} == {
            k: want[k] for k in ("flops", "bytes_accessed")}
        assert got["flops_global"] == 4 * got["flops"]


def test_extrapolate_rejects_a_count_that_shrinks_with_depth():
    base = {k: 10.0 for k in ("flops", "bytes_accessed", "flops_global",
                              "bytes_global")}
    two = dict(base, bytes_global=9.0)
    with pytest.raises(ValueError, match="bytes_global shrinks"):
        D._extrapolate(base, [(4, two)])


# ---------------------------------------------------------------------------
# Counts on meta
# ---------------------------------------------------------------------------

SHAPES = {"train": ShapeConfig("train", 32, 2, "train"),
          "prefill": ShapeConfig("prefill", 32, 2, "prefill"),
          "decode": ShapeConfig("decode", 32, 2, "decode")}
DEEP = [("qwen3-32b", "train"), ("qwen3-32b", "prefill"),
        ("qwen3-32b", "decode"), ("deepseek-v2-lite-16b", "train"),
        ("deepseek-v2-lite-16b", "decode"), ("mamba2-130m", "train"),
        ("mamba2-130m", "prefill"), ("jamba-1.5-large-398b", "decode"),
        ("whisper-medium", "prefill")]
KEYS = ("flops", "bytes_accessed", "flops_global", "bytes_global")


def _deepened(arch: str, rep: int = 4):
    """The smoke config with its repeating stage ``rep`` units deep (and
    the encoder ``rep`` layers deep)."""
    cfg = configs.smoke_config(arch)
    lead, unit, _, enc = D._stage_geometry(cfg)
    return dataclasses.replace(cfg, n_layers=lead + unit * rep,
                               encoder_layers=rep if enc else 0)


def _pcfg(kind: str):
    return configs.ParallelConfig(attn_chunk=16, remat="full"
                                  if kind == "train" else "none")


@pytest.mark.parametrize("arch,kind", DEEP)
def test_extrapolated_counts_equal_the_full_depth_count(arch, kind):
    cfg, shape, pcfg = _deepened(arch), SHAPES[kind], _pcfg(kind)
    mesh = make_host_mesh(device="cpu")
    lead, unit, rep, enc = D._stage_geometry(cfg)
    assert rep == 4

    def measure(units, enc_layers):
        return D._measure(D._variant(cfg, units, enc_layers), pcfg, shape,
                          mesh, 1)

    full = measure(rep, enc)
    base, two = measure(1, min(enc, 1)), measure(2, min(enc, 1))
    deltas = [(rep, two)]
    if enc:
        deltas.append((enc, measure(1, 2)))
    got = D._extrapolate(base, deltas)
    assert {k: got[k] for k in KEYS} == {k: full[k] for k in KEYS}
    assert two["flops"] > base["flops"] and two["bytes_accessed"] > base[
        "bytes_accessed"]


def _matmul_floor(cfg, pcfg, shape) -> float:
    """FLOPs of the matrix products a step cannot skip: 2 (train: 6) per
    active parameter per token, less the input embedding table (a gather,
    no FLOPs), an encoder's layers and cross-attention and, for prefill,
    the head on every token but the last (the step returns the last
    token's logits, in both packages)."""
    vd = pcfg.padded_vocab(cfg.vocab_size) * cfg.d_model
    lookup = cfg.vocab_size * cfg.d_model
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    body = hlo_stats.active_params(cfg) - lookup - (
        0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)
    if cfg.encoder_layers:  # the encoder runs on frames, not on tokens
        mats = 3 if cfg.ffn_type == "swiglu" else 2
        body -= cfg.encoder_layers * (cfg._attn_params()
                                      + mats * cfg.d_model * cfg.d_ff)
        body -= cfg.n_layers * cfg._attn_params()  # cross-attention
    head_tokens = shape.global_batch if shape.kind == "prefill" else tokens
    return mult * (body * tokens + vd * head_tokens)


@pytest.mark.parametrize("arch", ["qwen3-32b", "deepseek-v2-lite-16b",
                                  "mamba2-130m", "jamba-1.5-large-398b",
                                  "whisper-medium"])
def test_counted_flops_cover_the_step_s_matrix_products(arch):
    cfg = configs.smoke_config(arch)
    cfg = D._variant(cfg, 1, min(cfg.encoder_layers, 1))  # per unit
    mesh = make_host_mesh(device="cpu")
    for kind, shape in SHAPES.items():
        pcfg = _pcfg(kind)
        counted = D._measure(cfg, pcfg, shape, mesh, 1)["flops"]
        floor = _matmul_floor(cfg, pcfg, shape)
        assert counted >= floor, (kind, counted, floor)
        if kind == "train":
            tokens = shape.global_batch * shape.seq_len
            assert counted >= 2 * hlo_stats.active_params(cfg) * tokens


def _f32(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _i64(*shape):
    return torch.empty(shape, dtype=torch.int64, device="meta")


# (op, bytes): what the op reads plus what it writes, on float32 data and
# int64 indices
BYTE_CASES = {
    # a decode step's cache write: the new row (read), its index (read) and
    # the one row written, not the whole cache
    "index_copy_": (lambda: _f32(2, 64, 4, 8).index_copy_(
        1, _i64(1), _f32(2, 1, 4, 8)), 256 + 8 + 256),
    # the rows named are read and written
    "index_add_": (lambda: _f32(10, 4).index_add_(0, _i64(3), _f32(3, 4)),
                   48 + 24 + 2 * 48),
    "scatter_": (lambda: _f32(10, 4).scatter_(0, _i64(2, 4), _f32(2, 4)),
                 32 + 64 + 32),
    # a copy writes its destination without reading it
    "copy_": (lambda: _f32(5, 4).copy_(_f32(5, 4)), 80 + 80),
    "out=": (lambda: torch.add(_f32(5, 4), _f32(5, 4), out=_f32(5, 4)),
             80 + 80 + 80),
    # an in-place update reads and writes the whole tensor
    "add_": (lambda: _f32(5, 4).add_(_f32(5, 4)), 80 + 2 * 80),
    "fresh": (lambda: _f32(5, 4) * _f32(5, 4), 80 + 80 + 80),
    "view": (lambda: _f32(5, 4).view(20), 0),
}


@pytest.mark.parametrize("case", BYTE_CASES)
def test_byte_count_of_one_op(case):
    make, want = BYTE_CASES[case]
    with hlo_stats.ByteCounter() as counter:
        make()
    # the meta tensors' allocations move nothing
    assert counter.total == want


# ---------------------------------------------------------------------------
# A full-size cell, through run_cell and main
# ---------------------------------------------------------------------------

REF_RECORD_KEYS = {  # the reference's run_cell record (dryrun.py:224-301)
    "arch", "shape", "mesh", "kind", "status", "pcfg", "stage_geometry",
    "compile_s", "memory_analysis", "cost_analysis", "collectives",
    "roofline", "model_flops", "useful_flops_ratio", "analytic_memory",
    "variants"}


def test_run_cell_records_a_full_size_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "RESULTS_DIR", str(tmp_path))
    rec = D.run_cell("mamba2-130m", "decode_32k", "single")
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == REF_RECORD_KEYS - {"compile_s"} | {"count_s"}
    assert os.listdir(tmp_path) == ["mamba2-130m__decode_32k__single.json"]
    cfg, shape = configs.get_config("mamba2-130m"), configs.LM_SHAPES[
        "decode_32k"]
    assert rec["stage_geometry"] == {"lead": 0, "unit": 1, "dec_repeat": 24,
                                     "enc_repeat": 0}
    cost = rec["cost_analysis"]
    assert cost["transcendentals"] is None
    assert cost["flops"] * 256 == cost["flops_global"]
    assert cost["bytes_accessed"] * 256 == cost["bytes_global"]
    assert rec["collectives"] == {"counts": None, "result_bytes": None,
                                  "wire_bytes_per_device": None}
    roof = rec["roofline"]
    assert roof["t_collective_s"] is None and roof["n_devices"] == 256
    assert roof["t_memory_s"] == cost["bytes_accessed"] / hlo_stats.HBM_BW
    assert rec["model_flops"] == hlo_stats.model_flops(cfg, shape)
    assert rec["useful_flops_ratio"] == rec["model_flops"] / cost[
        "flops_global"]
    assert "fits_80gb" in rec["analytic_memory"]
    assert set(rec["variants"]) == {"base_1unit", "dec_2unit"}
    # the per-device argument bytes: params sharded 16-way over "model"
    # where divisible, the cache over batch and "model"
    assert 0 < rec["memory_analysis"]["argument_size_in_bytes"] < (
        cfg.params_billions() * 1e9 * 2)
    skipped = D.run_cell("qwen3-32b", "long_500k", "multi")
    assert skipped["status"] == "skipped" and "512k" in skipped["reason"]


def test_main_runs_one_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(D, "RESULTS_DIR", str(tmp_path))
    argv = ["--arch", "mamba2-130m", "--shape", "decode_32k", "--mesh",
            "single", "--force"]
    assert D.main(argv) == 0
    assert capsys.readouterr().out.startswith(
        "[ok] mamba2-130m decode_32k single:")
    assert D.main(argv[:-1]) == 0  # the record is reused
    assert "[cached]" in capsys.readouterr().out


def test_argument_bytes_follow_the_shardings():
    cfg = configs.smoke_config("deepseek-v2-lite-16b")
    pcfg = _pcfg("decode")
    for mesh in (make_host_mesh(device="cpu"), make_production_mesh()):
        low = D.lower_decode(cfg, pcfg, SHAPES["decode"], mesh)
        whole = sum(t.numel() * t.element_size() for a in low.args
                    for t in _leaves(a))
        if mesh.size == 1:
            assert low.argument_bytes() == whole
        else:
            assert low.argument_bytes() < whole
    assert all(t.device.type == "meta" for a in low.args for t in _leaves(a))


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [t for v in tree for t in _leaves(v)]

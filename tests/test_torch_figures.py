"""Port parity: the figure harness and the six figure drivers against the
reference's ``benchmarks/`` on two datasets at the quick size.

Both harnesses run every cell of ``kron`` and ``human`` (the quick sizes of
``QUICK_DATASET_KW``) once, each into its own cache under a temporary
directory; nothing is written under the repo's ``results/``.  The port runs
its ``hash_ref`` engine (the reference's ``_run`` hard-codes it) and, for one
cell, ``hash`` (the plain engine on the CPU), which must give the same
counts.  Each cell's counts, coalescing and filter numbers and report are
equal (wall seconds aside), and every figure driver's rows are equal to the
reference driver's.

The reference harness's side effects are undone by ``monkeypatch``: its
``RESULTS`` directory, the ``_QUICK`` flag that ``fig14``/``fig15`` set and
never reset, and the dataset table that ``all_cells`` and ``fig15`` (which
imports it by name) iterate.  The reference's ``accesses_per_group`` runs
compiled once a shape (``jax.jit`` of the same function; op by op it costs
seconds a BFS level), with the same result.
"""
from __future__ import annotations

import importlib
import sys
from pathlib import Path

import jax
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the reference's drivers live in benchmarks/
    sys.path.insert(0, str(ROOT))

from benchmarks import common as bcommon  # noqa: E402
from repro.core import coalescing as jco  # noqa: E402
from repro_torch.figures import common as tcommon  # noqa: E402

FIGS = ("fig4_overhead", "fig11_accesses", "fig12_noc", "fig13_perf_energy",
        "fig14_coalescing", "fig15_filter")
DATASETS = ("human", "kron")
WALL = ("baseline_wall_s", "iru_wall_s", "engine")


def _patch(mp, ref_dir, port_dir) -> None:
    """Point both harnesses at their caches, in quick mode, over DATASETS."""
    for common, figs, where in (
            (bcommon, "benchmarks", ref_dir),
            (tcommon, "repro_torch.figures", port_dir)):
        sub = {k: v for k, v in common.DATASET_KW.items() if k in DATASETS}
        mp.setattr(common, "RESULTS", str(where))
        mp.setattr(common, "_QUICK", True)
        mp.setattr(common, "DATASET_KW", sub)
        mp.setattr(importlib.import_module(f"{figs}.fig15_filter"),
                   "DATASET_KW", sub)
    mp.setattr(jco, "accesses_per_group", jax.jit(
        jco.accesses_per_group,
        static_argnames=("elem_bytes", "block_bytes", "group")))


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    ref_dir = tmp_path_factory.mktemp("bench_ref")
    port_dir = tmp_path_factory.mktemp("bench_torch")
    cells = {}
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp, ref_dir, port_dir)
        for algo in bcommon.ALGOS:
            for ds in DATASETS:
                cells[algo, ds] = (
                    bcommon.run_pair(algo, ds),
                    tcommon.run_pair(algo, ds, engine="hash_ref",
                                     device="cpu"))
    return ref_dir, port_dir, cells


@pytest.mark.parametrize("algo", ["bfs", "sssp", "pr"])
def test_cells_match_reference(caches, algo):
    _, port_dir, cells = caches
    for ds in DATASETS:
        want, got = cells[algo, ds]
        assert got["engine"] == "hash_ref"
        assert {k: v for k, v in got.items() if k not in WALL} == {
            k: v for k, v in want.items() if k not in WALL}
        assert got["iru"]["iru_elements"] > 0
        assert (port_dir / f"{algo}__{ds}__hash_ref__quick.json").exists()


def test_hash_engine_gives_the_oracle_s_counts(caches, tmp_path,
                                               monkeypatch):
    _, _, cells = caches
    _patch(monkeypatch, tmp_path / "ref", tmp_path)
    got = tcommon.run_pair("sssp", "kron", engine="hash", device="cpu")
    want = cells["sssp", "kron"][1]
    assert got["engine"] == "hash"
    assert {k: v for k, v in got.items() if k not in WALL} == {
        k: v for k, v in want.items() if k not in WALL}
    with pytest.raises(ValueError, match="engine"):
        tcommon.run_pair("bfs", "kron", engine="sort", device="cpu",
                         force=True)


@pytest.mark.parametrize("fig", FIGS)
def test_figure_rows_match_reference(caches, fig, monkeypatch):
    ref_dir, port_dir, _ = caches
    _patch(monkeypatch, ref_dir, port_dir)
    ref = importlib.import_module(f"benchmarks.{fig}")
    port = importlib.import_module(f"repro_torch.figures.{fig}")
    quick = dict(quick=True) if fig in ("fig14_coalescing",
                                        "fig15_filter") else {}
    want = ref.run(**quick)
    got = port.run(**quick, engine="hash_ref", device="cpu")
    assert got == want
    assert got[-1]["algo"] == "MEAN" and len(got) > len(DATASETS)


def test_figure_main_prints_the_rows(caches, monkeypatch, capsys):
    ref_dir, port_dir, _ = caches
    _patch(monkeypatch, ref_dir, port_dir)
    fig14 = importlib.import_module("repro_torch.figures.fig14_coalescing")
    fig14.main(["--quick", "--engine", "hash_ref", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    rows = fig14.run(engine="hash_ref", device="cpu")
    assert lines[0] == ("algo,dataset,baseline_acc_per_warp,"
                        "iru_acc_per_warp,improvement")
    assert len(lines) == len(rows) + 1 and lines[-1].startswith("MEAN,-,")

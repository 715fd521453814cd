"""The port stands alone: it imports neither ``jax`` nor ``repro``, and its
entry points run on the card unless the caller asks for the CPU.

Each check runs in a fresh interpreter, so what it blocks or hides (``jax``
and ``repro`` in ``sys.modules``, the card through ``CUDA_VISIBLE_DEVICES``)
never touches this process.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _run(code: str, **env_extra) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC), **env_extra)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax_or_repro():
    code = """
import pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    __import__(name)
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[k] is not None)
assert not leaked, leaked
print(len(names))
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20


def test_hash_path_runs_without_jax_or_repro():
    """The hash slice (oracle copy, plain engine, wrapper, ``hash_ref`` and
    the pipeline's hash mode) on the CPU, with ``jax`` and ``repro``
    blocked."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np, torch
from repro_torch.apps.bfs import BFS_APP, bfs
from repro_torch.core import FrontierPipeline, IRUConfig, iru_reorder
from repro_torch.graphs.generators import kron
from repro_torch.kernels.iru_reorder import ops, ref
idx = np.random.default_rng(0).integers(0, 300, 500).astype(np.int32)
val = np.ones(500, np.float32)
want = ref.ragged_oracle(ref.hash_reorder_ref, idx, val, 400, num_sets=16,
                         slots=4, filter_op="add")
got = ops.hash_reorder(torch.from_numpy(idx), torch.from_numpy(val),
                       num_sets=16, slots=4, filter_op="add", n_live=400)
oracle = iru_reorder(torch.from_numpy(idx), torch.from_numpy(val), n_live=400,
                     config=IRUConfig(mode="hash_ref", num_sets=16, slots=4,
                                      filter_op="add"))
for a, b, c in zip(want, got, oracle):
    assert np.array_equal(a, b.numpy()) and np.array_equal(a, c.numpy())
g = kron(scale=6, device="cpu")
label = FrontierPipeline(g, BFS_APP, mode="hash", device="cpu").run(0)
assert np.array_equal(label.numpy(), bfs(g, 0))
print("ok")
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_serving_path_runs_without_jax_or_repro():
    """The serving slice (views, PPR, fault plans, the fused engine in every
    reorder mode) on the CPU, with ``jax`` and ``repro`` blocked."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
from repro_torch.apps.ppr import ppr
from repro_torch.ft import QueryFaultPlan
from repro_torch.graphs.generators import kron
from repro_torch.serve import GraphQuery, GraphServeConfig, GraphServingEngine
g = kron(scale=6, device="cpu")
for mode in ("baseline", "sort", "hash"):
    eng = GraphServingEngine(g, GraphServeConfig(query_slots=2, mode=mode),
                             fault_plan=QueryFaultPlan(), device="cpu")
    qs = [GraphQuery("bfs", 0), GraphQuery("ppr", 1, iters=5),
          GraphQuery("sssp", 2)]
    for q in qs:
        eng.submit(q)
    eng.run_to_completion(500)
    assert all(q.done for q in qs)
    assert np.array_equal(qs[0].result, eng.solo_reference(qs[0]))
    assert np.allclose(qs[1].result, ppr(g, 1, iters=5), rtol=1e-4)
print("ok")
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_partitioned_path_runs_without_jax_or_repro():
    """The partitioned slice (``partition_csr``, ``repro_torch.dist``, the
    codecs and the engine on a partitioned view) on the CPU, with ``jax``
    and ``repro`` blocked."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np, torch
import repro_torch.dist as dist
from repro_torch.apps import bfs, pagerank
from repro_torch.graphs.csr import partition_csr, tile_csr
from repro_torch.graphs.generators import kron
from repro_torch.serve import GraphQuery, GraphServeConfig, GraphServingEngine
g = kron(scale=6, device="cpu")
part = partition_csr(g, 2)
label = dist.bfs_partitioned(part, 0, mode="hash", compress=True,
                             device="cpu")
assert np.array_equal(label.numpy(), bfs(g, 0))
rank = dist.pagerank_partitioned(part, iters=3, compress=True, device="cpu")
assert np.allclose(rank.numpy(), pagerank(g, iters=3), rtol=2e-3, atol=2e-3)
q, s = dist.quantize_rows_i8(torch.ones(2, 130))
assert q.dtype == torch.int8 and s.shape == (2, 2)
eng = GraphServingEngine(partition_csr(tile_csr(g, 3), 2),
                         GraphServeConfig(query_slots=3, mode="sort"),
                         device="cpu")
qs = [GraphQuery("bfs", 0), GraphQuery("ppr", 1, iters=3)]
for x in qs:
    eng.submit(x)
eng.run_to_completion(500)
assert all(x.done for x in qs)
assert np.array_equal(qs[0].result, bfs(g, 0))
print("ok")
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_figure_harness_runs_without_jax_or_repro(tmp_path):
    """The figure slice (generators, host apps with a recorder, the
    instrumented pipeline, the coalescing counts, the cost model and one
    harness cell) on the CPU, with ``jax`` and ``repro`` blocked; the cell's
    cache goes to ``tmp_path``."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch
from repro_torch.apps import BFS_APP, TraceRecorder, bfs_jit, pagerank_jit
from repro_torch.core import FrontierPipeline
from repro_torch.figures import common, fig15_filter
common.RESULTS = {str(tmp_path)!r}
common.set_quick(True)
cell = common.run_pair("sssp", "kron", engine="hash_ref", device="cpu")
assert cell["iru"]["iru_elements"] > 0 and 0 < cell["filtered_frac"] < 1
g = common.make_dataset("kron", scale=6, device="cpu")
rec = TraceRecorder()
label = FrontierPipeline(g, BFS_APP, mode="hash", device="cpu"
                         ).run_instrumented(0, recorder=rec)
assert torch.equal(label, bfs_jit(g, 0, device="cpu")) and rec.events
rank = pagerank_jit(g.edge_sources(), g.col_idx, g.degrees(), g.n_nodes,
                    iters=3, device="cpu")
assert bool(torch.isfinite(rank).all())
print("ok")
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
    assert [p.name for p in tmp_path.iterdir()] == [
        "sssp__kron__hash_ref__quick.json"]


def test_entry_points_need_cuda_unless_cpu_is_asked():
    code = """
import torch
from repro_torch.apps import (bfs_pipeline, pagerank_pipeline, ppr_pipeline,
                              sssp_pipeline)
from repro_torch.core import FrontierPipeline
from repro_torch.serve import GraphServingEngine
from repro_torch.apps.bfs import BFS_APP
from repro_torch.graphs.generators import kron, make_dataset
from repro_torch.apps import bfs, bfs_jit, pagerank_jit
from repro_torch.figures.common import run_pair
from repro_torch.dist import (PartitionedFrontierPipeline, bfs_partitioned,
                              partitioned_bfs_app)
from repro_torch.graphs.csr import partition_csr, tile_csr
assert not torch.cuda.is_available()
g = kron(scale=6, device="cpu")
part = partition_csr(g, 2)
calls = [lambda: FrontierPipeline(g, BFS_APP), lambda: bfs_pipeline(g),
         lambda: FrontierPipeline(g, BFS_APP, mode="hash"),
         lambda: sssp_pipeline(g), lambda: pagerank_pipeline(g, iters=2),
         lambda: ppr_pipeline(g, iters=2), lambda: GraphServingEngine(g),
         lambda: kron(scale=4), lambda: make_dataset("human", n=100),
         lambda: bfs(g, 0, mode="iru"), lambda: bfs_jit(g),
         lambda: pagerank_jit(g.edge_sources(), g.col_idx, g.degrees(),
                              g.n_nodes, iters=1),
         lambda: run_pair("bfs", "kron", force=True),
         lambda: PartitionedFrontierPipeline(part, partitioned_bfs_app(part)),
         lambda: bfs_partitioned(g, n_parts=2),
         lambda: GraphServingEngine(partition_csr(tile_csr(g, 8), 2))]
for call in calls:
    try:
        call()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("ran without CUDA and without device='cpu'")
label = bfs_pipeline(g, device="cpu")
assert label.device.type == "cpu" and int(label[0]) == 0
print("ok")
"""
    r = _run(code, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_chip_smoke_imports_only_the_port_torch_and_numpy():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    assert {"repro_torch", "torch", "numpy"} <= roots


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda_or_without_the_repo(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "alone":  # a directory holding chip_smoke.py and nothing else
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout

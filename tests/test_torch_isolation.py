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
assert {"repro_torch.dist.sharding", "repro_torch.launch.mesh",
        "repro_torch.launch.shardings", "repro_torch.launch.hlo_stats",
        "repro_torch.launch.dryrun"} <= set(names)
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


def test_partitioned_path_runs_without_jax_or_repro(tmp_path):
    """The partitioned slice (``partition_csr``, ``repro_torch.dist``, the
    codecs and the engine on a partitioned view) on the CPU, with ``jax``
    and ``repro`` blocked; then a group of one over gloo (the pipeline and
    ``allreduce_int8`` over a group mesh)."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import datetime
import numpy as np, torch
import torch.distributed as tdist
import repro_torch.dist as dist
from repro_torch.apps import bfs, pagerank
from repro_torch.graphs.csr import partition_csr, tile_csr
from repro_torch.graphs.generators import kron
from repro_torch.launch.mesh import make_graph_mesh, make_iru_mesh
from repro_torch.serve import GraphQuery, GraphServeConfig, GraphServingEngine
g = kron(scale=6, device="cpu")
part = partition_csr(g, 2)
label = dist.bfs_partitioned(part, 0, mode="hash", compress=True,
                             device="cpu")
assert np.array_equal(label.numpy(), bfs(g, 0))
rank = dist.pagerank_partitioned(part, iters=3, compress=True, device="cpu")
assert np.allclose(rank.numpy(), pagerank(g, iters=3), rtol=2e-3, atol=2e-3)
tdist.init_process_group("gloo", init_method="file://{tmp_path}/store",
                         rank=0, world_size=1,
                         timeout=datetime.timedelta(seconds=60))
mesh = make_graph_mesh(1, "cpu", group="world")
label = dist.bfs_partitioned(g, 0, mode="hash", compress=True, mesh=mesh)
assert np.array_equal(label.numpy(), bfs(g, 0))
rank = dist.pagerank_partitioned(g, iters=3, mesh=mesh)
assert np.allclose(rank.numpy(), pagerank(g, iters=3), rtol=1e-4, atol=1e-6)
y = dist.allreduce_int8(torch.ones(4, 3),
                        mesh=make_iru_mesh(1, "cpu", group="world"))
assert torch.allclose(y, torch.full((3,), 4.0))
tdist.destroy_process_group()
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


def test_moe_path_runs_without_jax_or_repro():
    """The MoE slice (config, oracle, planner, the three engines, stats,
    shared experts, expert parallel, the int8 collectives) on the CPU, with
    ``jax`` and ``repro`` blocked."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np, torch
from repro_torch.configs import MoEConfig
from repro_torch.dist import allreduce_int8, compress_grads_int8_ef
from repro_torch.kernels.iru_reorder.ref import moe_dispatch_ref
from repro_torch.models.common import Initializer
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.moe import (capacity, dispatch_stats, format_stats,
                             moe_hash, moe_hash_ep, plan_dispatch)
from repro_torch.moe.dispatch import _route
moe = MoEConfig(n_experts=4, top_k=2, d_ff=24, n_shared_experts=1,
                capacity_factor=0.5)
it = Initializer(torch.Generator().manual_seed(0), torch.float32, "cpu")
init_moe(it, 16, moe, "swiglu")
x = torch.randn(256, 16, generator=torch.Generator().manual_seed(1))
ys = {e: moe_ffn(it.params, x, moe, "swiglu", dispatch=e)[0]
      for e in ("iru_hash", "iru_sorted", "dense")}
for y in ys.values():
    assert torch.allclose(y, ys["iru_hash"], rtol=1e-4, atol=1e-5)
gates, experts, _ = _route(it.params, x, moe)
C = capacity(256, moe)
plan = plan_dispatch(experts, gates, C, 4)
rank, keep, counts, dropped = moe_dispatch_ref(experts.numpy(), C, 4)
assert np.array_equal(plan.keep.numpy(), keep) and dropped.sum() > 0
assert "drop_rate" in format_stats(dispatch_stats(plan))
y, _ = moe_hash(it.params, x, moe, "swiglu", n_live=torch.tensor(100))
assert not y[100:].any()
ye, _ = moe_hash_ep(it.params, x, moe, "swiglu", n_shards=2,
                    compress=False)
yh, _ = moe_hash(it.params, x, moe, "swiglu")
assert torch.allclose(ye, yh, rtol=1e-5, atol=1e-6)
assert allreduce_int8(torch.ones(4, 3), 2).shape == (3,)
deq, ef = compress_grads_int8_ef({"w": x}, {"w": torch.zeros_like(x)})
assert torch.equal(deq["w"] + ef["w"], x)
print("ok")
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_lm_path_runs_without_jax_or_repro():
    """The LM slice (configs, the IRU embedding, GQA/MLA attention, Mamba-2,
    the stack's forward, prefill and decode) on the CPU, with ``jax`` and
    ``repro`` blocked: a smoke deepseek and a smoke mamba2."""
    code = """
import dataclasses, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch
from repro_torch.configs import ParallelConfig, get_config, smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.embedding import embed
pcfg = ParallelConfig(attn_chunk=16)
assert abs(get_config("deepseek-v2-lite-16b").params_billions() - 15.65) < 0.01
for arch in ("deepseek-v2-lite-16b", "mamba2-130m"):
    cfg = dataclasses.replace(smoke_config(arch), dtype=torch.float32)
    params, _ = T.init_params(cfg, pcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    full, _ = T.forward_train(params, cfg, pcfg, {"tokens": toks})
    cache = T.init_cache(cfg, pcfg, 2, 24, device="cpu")
    lg, cache = T.prefill(params, cfg, pcfg, {"tokens": toks[:, :20]}, cache)
    assert torch.allclose(lg[:, 0], full[:, 19], rtol=1e-4, atol=1e-4)
    for t in range(20, 24):
        lg, cache = T.decode_step(params, cfg, pcfg, toks[:, t:t + 1], cache, t)
        assert torch.allclose(lg[:, 0], full[:, t], rtol=1e-4, atol=1e-4)
    assert torch.equal(embed(params["embed"], toks, iru=True),
                       embed(params["embed"], toks, iru=False))
print("ok")
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_lm_serving_path_runs_without_jax_or_repro():
    """The LM serving slice (the continuous-batching engine and the serve
    launcher) on the CPU, with ``jax`` and ``repro`` blocked: a smoke
    deepseek and a smoke mamba2 serve more requests than slots, one of them
    stopped by its EOS."""
    code = """
import dataclasses, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np, torch
from repro_torch.configs import ParallelConfig, smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.serve import Request, ServeConfig, ServingEngine
pcfg = ParallelConfig(remat="none", attn_chunk=16)
for arch in ("deepseek-v2-lite-16b", "mamba2-130m"):
    cfg = dataclasses.replace(smoke_config(arch), dtype=torch.float32)
    params, _ = T.init_params(cfg, pcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    eng = ServingEngine(cfg, pcfg, params, ServeConfig(batch_slots=2,
                                                       max_seq=32),
                        device="cpu")
    probe = Request(prompt=np.array([4, 5], np.int32), max_new_tokens=2)
    eng.submit(probe)
    eng.run_to_completion()
    reqs = [Request(prompt=np.array([4, 5], np.int32), max_new_tokens=9,
                    eos_id=probe.generated[0])]
    reqs += [Request(prompt=np.arange(1, 2 + i, dtype=np.int32),
                     max_new_tokens=3) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    assert [len(r.generated) for r in reqs] == [1, 3, 3, 3, 3]
reqs = launch_serve.main(["--device", "cpu", "--smoke", "--requests", "3",
                          "--slots", "2", "--max-new", "2"])
assert [len(r.generated) for r in reqs] == [2, 2, 2]
print("ok")
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok"


def test_training_path_runs_without_jax_or_repro(tmp_path):
    """The training slice (AdamW in three moment precisions, the schedule,
    the loss, the Zipf stream, the train step with microbatches and remat,
    checkpoints, the supervisor and the launcher) on the CPU, with ``jax``
    and ``repro`` blocked."""
    code = f"""
import dataclasses, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch
from repro_torch.ckpt import CheckpointManager, restore_checkpoint
from repro_torch.configs import ParallelConfig, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import make_batch
from repro_torch.ft import FaultInjector, FaultPlan, Supervisor, SupervisorConfig
from repro_torch.launch import train as launch_train
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, abstract_state, init_state, make_train_step
cfg = dataclasses.replace(smoke_config("deepseek-v2-lite-16b"), dtype=torch.float32)
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="iru_hash"))
shape = ShapeConfig("t", 32, 4, "train")
for sd in ("fp32", "bf16", "int8"):
    pcfg = ParallelConfig(remat="full", microbatches=2, attn_chunk=16)
    tc = TrainConfig(adam=AdamWConfig(state_dtype=sd), warmup_steps=1)
    state = init_state(cfg, pcfg, tc, torch.Generator().manual_seed(0), device="cpu")
    sup = Supervisor(CheckpointManager({str(tmp_path)!r} + "/" + sd),
                     SupervisorConfig(ckpt_every=2),
                     injector=FaultInjector(FaultPlan(die_at=(3,))))
    state, last = sup.run(state, make_train_step(cfg, pcfg, tc),
                          lambda s: make_batch(cfg, shape, s, device="cpu"), 0, 4)
    assert last == 4 and sup.restarts == 1
    assert len(sup.history[-1]["moe_drop_rate"]) == 1
    back = restore_checkpoint({str(tmp_path)!r} + "/" + sd,
                              abstract_state(cfg, pcfg, tc)[0], device="cpu")
    assert int(back["opt"]["step"]) == 4
launch_train.main(["--device", "cpu", "--smoke", "--steps", "3", "--batch", "2",
                   "--seq", "16", "--ckpt", {str(tmp_path / "launch")!r}])
print("ok")
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok"


def test_dry_run_runs_without_jax_or_repro(tmp_path):
    """The dry-run slice (the sharding layer, the meshes, the state
    shardings, the counting modes and one full-size cell on ``meta``) with
    ``jax`` and ``repro`` blocked and no card; the record goes to
    ``tmp_path``."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch
from repro_torch.dist.sharding import P, resolve_spec, use_mesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
assert not torch.cuda.is_available()
mesh = make_production_mesh(multi_pod=True)
assert resolve_spec(("batch", "seq"), (256, 4096), mesh) == P(("pod", "data"), None)
dryrun.RESULTS_DIR = {str(tmp_path)!r}
rec = dryrun.run_cell("mamba2-130m", "decode_32k", "multi")
assert rec["status"] == "ok", rec.get("traceback")
assert rec["roofline"]["n_devices"] == 512 and rec["analytic_memory"]["fits_80gb"]
print("ok")
"""
    r = _run(code, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
    assert [p.name for p in tmp_path.iterdir()] == [
        "mamba2-130m__decode_32k__multi.json"]


def test_sharding_layer_loads_no_other_dist_module():
    """``models.common`` imports ``dist.sharding``: that loads neither the
    partitioned pipeline nor the collectives, while the package's names
    still resolve on first use."""
    code = """
import sys
import repro_torch.dist.sharding
loaded = sorted(k for k in sys.modules if k.startswith("repro_torch."))
assert loaded == ["repro_torch.device", "repro_torch.dist",
                  "repro_torch.dist.sharding"], loaded
from repro_torch.dist import bfs_partitioned, allreduce_int8
assert "repro_torch.dist.graph_partition" in sys.modules
print("ok")
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_entry_points_need_cuda_unless_cpu_is_asked():
    code = """
import os
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
from repro_torch.configs import MoEConfig
from repro_torch.models.common import Initializer
from repro_torch.models.moe import init_moe
from repro_torch.configs import ParallelConfig, smoke_config
from repro_torch.models import transformer as T
from repro_torch.ckpt import restore_checkpoint
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import make_batch, synthetic_stream
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch import partitioned as launch_partitioned
from repro_torch.launch.mesh import (make_graph_mesh, make_host_mesh,
                                     make_iru_mesh)
from repro_torch.serve import ServingEngine
from repro_torch.train import TrainConfig, init_state
from repro_torch.kernels.iru_reorder.ops import hash_reorder
assert not torch.cuda.is_available()
lm = smoke_config("deepseek-v2-lite-16b")
g = kron(scale=6, device="cpu")
moe = MoEConfig(n_experts=4, top_k=2, d_ff=8)
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
         lambda: GraphServingEngine(partition_csr(tile_csr(g, 8), 2)),
         lambda: Initializer(torch.Generator()),
         lambda: init_moe(Initializer(torch.Generator(), torch.float32), 8,
                          moe, "swiglu"),
         lambda: T.init_params(lm, ParallelConfig(), torch.Generator()),
         lambda: T.init_cache(lm, ParallelConfig(), 2, 8),
         lambda: Initializer(torch.Generator()).vmap_unit(
             "s", 2, lambda it: it.weight("w", (2,), (None,))),
         lambda: init_state(lm, ParallelConfig(), TrainConfig(),
                            torch.Generator()),
         lambda: make_batch(lm, ShapeConfig("t", 8, 2, "train"), 0),
         lambda: synthetic_stream(lm, ShapeConfig("t", 8, 2, "train")),
         lambda: restore_checkpoint("no-such-dir", {}),
         lambda: launch_train.main(["--smoke", "--steps", "1",
                                    "--ckpt", "no-such-dir"]),
         lambda: ServingEngine(lm, ParallelConfig(), {}),
         lambda: launch_serve.main(["--smoke", "--requests", "1"]),
         make_host_mesh,
         lambda: make_graph_mesh(1, group="world"),
         lambda: make_iru_mesh(1, group="world"),
         lambda: launch_partitioned.main(group + ["--nproc", "2"]),
         lambda: launch_partitioned.main(group),
         lambda: GraphServingEngine(partition_csr(tile_csr(g, 8), 1),
                                    mesh=make_graph_mesh(1, group="world")),
         lambda: hash_reorder(g.col_idx, n_partitions=2,
                              mesh=make_iru_mesh(2, group="world"))]
group = ["--backend", "gloo", "--graph", "kron:4:4", "--app", "bfs"]
os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
for call in calls:
    try:
        call()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("ran without CUDA and without device='cpu'")
label = bfs_pipeline(g, device="cpu")
assert label.device.type == "cpu" and int(label[0]) == 0
it = Initializer(torch.Generator(), device="cpu")
init_moe(it, 8, moe, "swiglu")
assert it.params["wi"].device.type == "cpu"
# a group mesh on the CPU, asked for: the engine and the banked rows run
import tempfile
import torch.distributed as dist
with tempfile.TemporaryDirectory() as tmp:
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    eng = GraphServingEngine(partition_csr(tile_csr(g, 8), 1),
                             mesh=make_graph_mesh(1, "cpu", group="world"))
    assert eng.device.type == "cpu"
    out = hash_reorder(g.col_idx, n_partitions=2,
                       mesh=make_iru_mesh(2, "cpu", group="world"))
    assert out.indices.device.type == "cpu"
    dist.destroy_process_group()
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

"""Port parity: the sharding layer (``repro_torch.dist.sharding``,
``launch.mesh``, ``launch.shardings``), the roofline helpers of
``launch.hlo_stats`` and ``models.common.constrain`` against the reference.

``resolve_spec`` and ``zero_fragment`` give the reference's entries on the
cases of ``tests/test_sharding.py`` and on seeded random cases; at full size,
on ``jax.sharding.AbstractMesh``es of the production shapes, every leaf of
the ten architectures' state, batch and cache shardings has the reference's
spec and shard shape.  The reference's own meshes (``jax.make_mesh``) need
256 devices and are not built.  ``constrain`` is called at the reference's
sites with the same logical axes and shapes, and leaves the forward's
output bit for bit unchanged.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.dist import sharding as jsh
from repro.launch import hlo_stats as jhlo
from repro.launch import shardings as jshardings
from repro.models import transformer as JT
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train import trainer as jtrainer
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline as pipe
from repro_torch.dist import sharding as sh
from repro_torch.launch import hlo_stats, shardings
from repro_torch.launch import mesh as pmesh
from repro_torch.models import common
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import trainer

ARCHS = jconfigs.ARCH_IDS
PROD = {"single": (("data", "model"), (16, 16)),
        "multi": (("pod", "data", "model"), (2, 16, 16))}


class FakeMesh:
    """Duck-typed mesh: only .shape (a dict) is consulted."""

    def __init__(self, **axes):
        self.shape = dict(axes)


def _meshes(kind: str):
    """(port mesh, reference AbstractMesh) of a production shape."""
    names, sizes = PROD[kind]
    return pmesh.Mesh(names, sizes), AbstractMesh(sizes, names)


# ---------------------------------------------------------------------------
# Rules, resolve_spec and zero_fragment
# ---------------------------------------------------------------------------

def test_default_rules_match_reference():
    assert list(sh.DEFAULT_RULES) == list(jsh.DEFAULT_RULES)
    for name, rule in sh.DEFAULT_RULES.items():
        ref = jsh.DEFAULT_RULES[name]
        assert (rule.candidates, rule.priority) == (ref.candidates,
                                                   ref.priority), name


SHARDING_CASES = [  # tests/test_sharding.py's cases: (mesh, axes, shape)
    (dict(pod=2, data=16, model=16), ("batch", "seq"), (256, 4096)),
    (dict(data=16, model=16), ("batch", "kv_seq", "kv_heads", None),
     (128, 32768, 8, 128)),
    (dict(data=16, model=16), ("batch", "kv_seq", "kv_heads", None),
     (1, 524288, 8, 128)),
    (dict(data=4, model=4), ("ffn", "experts"), (64, 64)),
    (dict(data=16, model=16), ("experts", "embed", "moe_ffn"),
     (64, 2048, 1408)),
    (dict(data=16, model=16), ("experts", "embed", "moe_ffn"),
     (8, 6144, 32768)),
]


@pytest.mark.parametrize("case", range(len(SHARDING_CASES)))
def test_resolve_spec_matches_reference_on_its_cases(case):
    axes, names, shape = SHARDING_CASES[case]
    mesh = FakeMesh(**axes)
    got = sh.resolve_spec(names, shape, mesh)
    want = jsh.resolve_spec(names, shape, mesh)
    assert isinstance(got, tuple) and tuple(got) == tuple(want)
    assert tuple(sh.zero_fragment(got, shape, mesh)) == tuple(
        jsh.zero_fragment(want, shape, mesh))


def test_zero_fragment_matches_reference_on_its_cases():
    mesh = FakeMesh(pod=2, data=16, model=16)
    for spec, shape in (((None, "model"), (8192, 1024)), ((None,), (7,))):
        got = sh.zero_fragment(sh.P(*spec), shape, mesh)
        assert tuple(got) == tuple(jsh.zero_fragment(JP(*spec), shape, mesh))
    assert sh.zero_fragment(sh.P(None, "model"), (8192, 1024), mesh) == sh.P(
        ("pod", "data"), "model")


MESH_KINDS = {"data_model": ("data", "model"),
              "pod_data_model": ("pod", "data", "model"),
              "part": ("part",), "gpart": ("gpart",)}


@pytest.mark.parametrize("kind", list(MESH_KINDS))
def test_resolve_and_zero_fragment_match_reference_on_random_cases(kind):
    """500 seeded cases a mesh kind (2000 in all): logical axes drawn from
    the rule names and None, dims products of 1, 2, 3, 4, 8 and 16, axis
    sizes 1-16."""
    rng = np.random.default_rng(list(MESH_KINDS).index(kind))
    names = list(sh.DEFAULT_RULES) + [None]
    factors = np.array([1, 2, 3, 4, 8, 16])
    for _ in range(500):
        mesh = FakeMesh(**{a: int(rng.integers(1, 17))
                           for a in MESH_KINDS[kind]})
        nd = int(rng.integers(1, 5))
        axes = tuple(names[i] for i in rng.integers(0, len(names), nd))
        shape = tuple(int(np.prod(rng.choice(factors, rng.integers(1, 4))))
                      for _ in range(nd))
        got = sh.resolve_spec(axes, shape, mesh)
        want = jsh.resolve_spec(axes, shape, mesh)
        assert tuple(got) == tuple(want), (mesh.shape, axes, shape)
        assert tuple(sh.zero_fragment(got, shape, mesh)) == tuple(
            jsh.zero_fragment(want, shape, mesh)), (mesh.shape, axes, shape)


def test_partition_spec_and_named_sharding_follow_jax():
    for entries in ((("pod", "data"), None, "model"), (["a", "b"],),
                    ((),), ((None,),), (("a",), "b"), ()):
        got = sh.P(*entries)
        assert isinstance(got, tuple) and tuple(got) == tuple(JP(*entries))
    for bad in ((3,), (("a", 3),)):
        with pytest.raises(TypeError):
            sh.P(*bad)
    port, ref = _meshes("multi")
    spec = (("pod", "data"), None, "model")
    assert sh.NamedSharding(port, sh.P(*spec)).shard_shape(
        (256, 7, 32)) == JNamedSharding(ref, JP(*spec)).shard_shape(
        (256, 7, 32))
    with pytest.raises(ValueError, match="dimension size is 250"):
        sh.NamedSharding(port, sh.P("data")).shard_shape((250,))


# ---------------------------------------------------------------------------
# Whole-state shardings at full size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def states():
    """arch -> {moments: (port state, port specs, ref state, ref specs)}:
    one abstract_state per architecture and moment dtype, at the
    production meshes' ParallelConfig (model axis 16 in both)."""
    cache: dict = {}

    def get(arch: str):
        if arch not in cache:
            _, ref_mesh = _meshes("single")
            shape = jconfigs.LM_SHAPES["train_4k"]
            jpcfg = jshardings.default_pcfg(jconfigs.get_config(arch), shape,
                                            ref_mesh)
            pcfg = configs.ParallelConfig(**dataclasses.asdict(jpcfg))
            cache[arch] = {}
            for sd in ("fp32", "int8"):
                ref = jtrainer.abstract_state(
                    jconfigs.get_config(arch), jpcfg,
                    jtrainer.TrainConfig(adam=JAdamWConfig(state_dtype=sd)))
                port = trainer.abstract_state(
                    configs.get_config(arch), pcfg,
                    trainer.TrainConfig(adam=AdamWConfig(state_dtype=sd)))
                cache[arch][sd] = (*port, *ref)
        return cache[arch]

    return get


def _same_shardings(got, want, shapes, path="") -> int:
    """Walk both sharding trees with the shape tree; every leaf's spec and
    shard shape equal.  Returns the number of leaves."""
    if isinstance(got, sh.NamedSharding):
        assert isinstance(want, JNamedSharding), path
        assert tuple(got.spec) == tuple(want.spec), path
        shape = tuple(shapes.shape)
        assert got.shard_shape(shape) == want.shard_shape(shape), path
        return 1
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), path
        return sum(_same_shardings(got[k], want[k], shapes[k], f"{path}/{k}")
                   for k in got)
    assert isinstance(got, (list, tuple)) and len(got) == len(want), path
    return sum(_same_shardings(g, w, s, f"{path}/{i}")
               for i, (g, w, s) in enumerate(zip(got, want, shapes)))


@pytest.mark.parametrize("arch", ARCHS)
def test_state_batch_and_cache_shardings_match_reference_at_full_size(
        arch, states):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for kind in PROD:
        port_mesh, ref_mesh = _meshes(kind)
        for name, shape in configs.LM_SHAPES.items():
            got = shardings.default_pcfg(cfg, shape, port_mesh)
            want = jshardings.default_pcfg(jcfg, jconfigs.LM_SHAPES[name],
                                           ref_mesh)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        fsdp = got.fsdp_params
        for sd, (st, specs, jst, jspecs) in states(arch).items():
            n = _same_shardings(
                shardings.state_shardings(st, specs, port_mesh,
                                          fsdp_params=fsdp),
                jshardings.state_shardings(jst, jspecs, ref_mesh,
                                           fsdp_params=fsdp), st)
            assert n == len(jax.tree.leaves(jst)), (kind, sd)
        pcfg = dataclasses.replace(got, remat="none")
        jpcfg = jconfigs.ParallelConfig(**dataclasses.asdict(pcfg))
        for name, shape in configs.LM_SHAPES.items():
            if not configs.shape_applicable(cfg, shape)[0]:
                continue
            b, b_axes = pipe.batch_specs(cfg, shape)
            jb, jb_axes = jpipe.batch_specs(jcfg, jconfigs.LM_SHAPES[name])
            assert b_axes == jb_axes
            _same_shardings(shardings.shard_tree(b, b_axes, port_mesh),
                            jshardings.shard_tree(jb, jb_axes, ref_mesh), b)
            if shape.kind == "train":
                continue
            B, S = shape.global_batch, shape.seq_len
            c = T.init_cache(cfg, pcfg, B, S, abstract=True)
            c_axes = T.cache_axes(cfg, pcfg)
            jc = JT.init_cache(jcfg, jpcfg, B, S, abstract=True)
            _same_shardings(
                shardings.shard_tree(c, c_axes, port_mesh),
                jshardings.shard_tree(jc, JT.cache_axes(jcfg, jpcfg),
                                      ref_mesh), c)
            tok = torch.empty((B, 1), dtype=torch.int32, device="meta")
            _same_shardings(
                shardings.shard_tree(tok, ("batch", "seq"), port_mesh),
                jshardings.shard_tree(jax.ShapeDtypeStruct((B, 1), np.int32),
                                      ("batch", "seq"), ref_mesh), tok)


def test_iru_partition_axis_matches_reference():
    for kind in PROD:
        port, ref = _meshes(kind)
        assert shardings.iru_partition_axis(port) == \
            jshardings.iru_partition_axis(ref)
    for axes in (dict(part=4), dict(gpart=2, data=1)):
        fake = FakeMesh(**axes)
        assert shardings.iru_partition_axis(fake) == \
            jshardings.iru_partition_axis(fake)
    mesh = pmesh.make_iru_mesh(4, device="cpu")
    assert shardings.iru_partition_axis(mesh) == "part"
    assert mesh.shape == {"part": 1}


# ---------------------------------------------------------------------------
# Roofline helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_active_params_match_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert hlo_stats.active_params(cfg) == jhlo.active_params(jcfg)
    assert hlo_stats.active_params(configs.smoke_config(arch)) == \
        jhlo.active_params(jconfigs.smoke_config(arch))
    for name, shape in configs.LM_SHAPES.items():
        assert hlo_stats.model_flops(cfg, shape) == jhlo.model_flops(
            jcfg, jconfigs.LM_SHAPES[name])
    odd = ShapeConfig("odd", 100, 3, "prefill")
    assert hlo_stats.model_flops(cfg, odd) == jhlo.model_flops(jcfg, odd)


def test_roofline_bottleneck_on_h100_constants():
    assert (hlo_stats.PEAK_FLOPS, hlo_stats.HBM_BW,
            hlo_stats.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    r = hlo_stats.Roofline(flops=1e15, hbm_bytes=1e9, wire_bytes=1e6,
                           n_devices=256)
    assert r.bottleneck == "compute"
    assert r.t_compute == 1e15 / 989e12
    r = hlo_stats.Roofline(flops=1e12, hbm_bytes=1e13, wire_bytes=1e6,
                           n_devices=256)
    assert r.bottleneck == "memory" and r.t_memory == 1e13 / 3.35e12
    r = hlo_stats.Roofline(flops=1e12, hbm_bytes=1e9, wire_bytes=1e12,
                           n_devices=256)
    assert r.bottleneck == "collective" and r.t_collective == 1e12 / 450e9
    for flops, nbytes, want in ((1e15, 1e9, "compute"),
                                (1e12, 1e13, "memory")):
        r = hlo_stats.Roofline(flops, nbytes, None, 1)
        assert r.t_collective is None and r.bottleneck == want
        d = r.as_dict()
        assert d["t_collective_s"] is None
        assert d["wire_bytes_per_device"] is None
        assert set(d) == set(jhlo.Roofline(1.0, 1.0, 1.0, 1).as_dict())


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

def test_mesh_constructors(monkeypatch):
    for multi, kind in ((False, "single"), (True, "multi")):
        mesh = pmesh.make_production_mesh(multi_pod=multi)
        _, ref = _meshes(kind)
        assert mesh.shape == dict(ref.shape) and mesh.size == ref.size
        assert mesh.devices is None  # abstract
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (pmesh.make_host_mesh, lambda: pmesh.make_iru_mesh(4),
                 lambda: pmesh.make_graph_mesh(1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    host = pmesh.make_host_mesh(device="cpu")
    assert host.shape == {"data": 1, "model": 1} and host.size == 1
    assert host.devices == (torch.device("cpu"),)
    assert pmesh.make_iru_mesh(6, device="cpu").shape == {"part": 1}
    assert pmesh.make_graph_mesh(1, device="cpu").shape == {"gpart": 1}
    with pytest.raises(ValueError, match="need 4 devices .* have 1"):
        pmesh.make_graph_mesh(4, device="cpu")
    with pytest.raises(ValueError):
        pmesh.Mesh(("data",), (2,), (torch.device("cpu"),))


# ---------------------------------------------------------------------------
# constrain
# ---------------------------------------------------------------------------

def _py_scan(body, init, xs, length=None):
    """``lax.scan`` as a Python loop, so the reference's stage bodies run
    (and call ``constrain``) once a repeat, as the port's do."""
    n = length if length is not None else jax.tree.leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        carry, y = body(carry, jax.tree.map(lambda a: a[i], xs))
        ys.append(y)
    return carry, jax.tree.map(lambda *a: jax.numpy.stack(a), *ys)


@pytest.mark.parametrize("arch", ["qwen3-32b", "deepseek-v2-lite-16b",
                                  "mamba2-130m"])
def test_constrain_sites_match_reference_and_change_nothing(arch,
                                                            monkeypatch):
    from repro.models import attention as JA
    from repro.models import embedding as JE
    from repro.models import mamba2 as JM

    cfg = dataclasses.replace(configs.smoke_config(arch), dtype=torch.float32)
    pcfg = configs.ParallelConfig(remat="none", attn_chunk=16)
    params, _ = T.init_params(cfg, pcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24),
                                             dtype=np.int32)
    batch = {"tokens": torch.from_numpy(toks)}

    want: list = []

    def record(x, axes):
        want.append((tuple(axes), tuple(x.shape)))
        return x

    for mod in (JA, JE, JM, JT):
        monkeypatch.setattr(mod, "constrain", record)
    monkeypatch.setattr(JT, "mscan", _py_scan)
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch),
                               dtype=jax.numpy.float32)
    jparams = jax.tree.map(lambda p: jax.numpy.asarray(p.numpy().copy()),
                           params)
    jpcfg = jconfigs.ParallelConfig(remat="none", attn_chunk=16)
    jax.jit(lambda p, b: JT.forward_train(p, jcfg, jpcfg, b))(
        jparams, {"tokens": toks})

    got: list = []
    real = common.resolve_spec

    def spy(axes, shape, mesh):
        got.append((tuple(axes), tuple(shape)))
        return real(axes, shape, mesh)

    monkeypatch.setattr(common, "resolve_spec", spy)
    plain, _ = T.forward_train(params, cfg, pcfg, batch)
    assert got == []  # outside a mesh constrain returns at once
    with sh.use_mesh(FakeMesh(data=16, model=16)):
        assert sh.current_mesh().shape == {"data": 16, "model": 16}
        meshed, _ = T.forward_train(params, cfg, pcfg, batch)
        with sh.no_constraints():
            T.forward_train(params, cfg, pcfg, batch)
    assert sh.current_mesh() is None
    assert len(want) > 0 and got == want
    assert torch.equal(meshed, plain)


def test_constrain_raises_on_a_wrong_axes_tuple():
    x = torch.zeros(2, 3)
    assert common.constrain(x, ("batch",)) is x  # no mesh: no check
    with sh.use_mesh(pmesh.make_host_mesh(device="cpu")):
        assert common.constrain(x, ("batch", "embed")) is x
        with pytest.raises(AssertionError):
            common.constrain(x, ("batch",))

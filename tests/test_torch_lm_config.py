"""Port parity: the LM configs (``repro_torch.configs``) and the model's
static structure (stage plan, param and cache trees) against
``repro.configs`` and ``repro.models.transformer``.

Every field of each of the ten architectures' configs and of their smoke
reductions equals the reference's (dtypes mapped: jnp's to torch's); the
derived quantities (``params_billions``, ``unit_len``, ``layer_kinds``,
``stage_plan``, ``shape_applicable``, padding) are equal exactly.  At full
size, ``abstract_params`` (on the ``meta`` device) gives the reference's
param tree -- keys, shapes, dtypes and logical-axis specs -- and
``cache_struct`` its cache tree.  Nothing here draws a weight.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.models import transformer as T

ARCHS = jconfigs.ARCH_IDS


def _dt(d) -> str:
    """A jnp or torch dtype's name ('bfloat16', 'float32', ...)."""
    if isinstance(d, torch.dtype):
        return str(d).removeprefix("torch.")
    return np.dtype(d).name


def _fields(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = (type(v).__name__, _fields(v))
        elif f.name == "dtype":
            v = _dt(v)
        out[f.name] = v
    return out


def test_registry_matches_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert sorted(configs.REGISTRY) == sorted(jconfigs.REGISTRY)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("nope")
    assert _fields(base.MambaConfig()) == _fields(jbase.MambaConfig())
    assert _fields(base.ParallelConfig()) == _fields(jbase.ParallelConfig())


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch):
    cfg, ref = configs.get_config(arch), jconfigs.get_config(arch)
    assert _fields(cfg) == _fields(ref)
    assert cfg.dtype is torch.bfloat16
    assert _fields(configs.smoke_config(arch)) == _fields(
        jconfigs.smoke_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_derived_quantities_match_reference(arch):
    for get in ("get_config", "smoke_config"):
        cfg = getattr(configs, get)(arch)
        ref = getattr(jconfigs, get)(arch)
        assert cfg.params_billions() == ref.params_billions()
        assert cfg.unit_len() == ref.unit_len()
        assert cfg.layer_kinds() == ref.layer_kinds()
        assert ([cfg.is_moe_layer(i) for i in range(cfg.n_layers)]
                == [ref.is_moe_layer(i) for i in range(ref.n_layers)])
        plan = [(rep, [dataclasses.astuple(s) for s in specs])
                for rep, specs in T.stage_plan(cfg)]
        want = [(rep, [dataclasses.astuple(s) for s in specs])
                for rep, specs in JT.stage_plan(ref)]
        assert plan == want
        for name in jbase.LM_SHAPES:
            assert (base.shape_applicable(cfg, base.LM_SHAPES[name])
                    == jbase.shape_applicable(ref, jbase.LM_SHAPES[name]))
        for axis in (1, 16):
            p, jp = (base.ParallelConfig(model_axis=axis),
                     jbase.ParallelConfig(model_axis=axis))
            assert p.padded_vocab(cfg.vocab_size) == jp.padded_vocab(
                ref.vocab_size)
            assert p.padded_heads(cfg.n_heads) == jp.padded_heads(ref.n_heads)


def test_shapes_and_helpers_match_reference():
    assert ({k: dataclasses.astuple(v) for k, v in base.LM_SHAPES.items()}
            == {k: dataclasses.astuple(v)
                for k, v in jbase.LM_SHAPES.items()})
    assert base.SUBQUADRATIC_FAMILIES == jbase.SUBQUADRATIC_FAMILIES
    for x, m in ((0, 256), (1, 256), (50280, 256), (36, 16), (48, 16)):
        assert base.pad_to_multiple(x, m) == jbase.pad_to_multiple(x, m)


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference_at_full_size(arch):
    """The whole model's param tree at full width and depth, on ``meta``:
    the reference's keys, shapes (each stage's leading ``[rep]``), dtypes
    and specs; its size is ``params_billions``' count plus what that count
    leaves out (padding, norms, MLA's rope slice of ``wq``)."""
    cfg, ref = configs.get_config(arch), jconfigs.get_config(arch)
    pcfg, jpcfg = base.ParallelConfig(), jbase.ParallelConfig()
    params, specs = T.abstract_params(cfg, pcfg)
    jparams, jspecs = JT.abstract_params(ref, jpcfg)
    got = {k: (tuple(v.shape), _dt(v.dtype)) for k, v in
           _flatten(params).items()}
    want = {k: (tuple(v.shape), _dt(v.dtype)) for k, v in
            _flatten(jparams).items()}
    assert got == want
    assert all(v.device.type == "meta" for v in _flatten(params).values())
    flat_specs = _flatten(specs)
    assert flat_specs == {k: tuple(v) for k, v in _flatten(jspecs).items()}
    assert all(_is_axes(v) for v in flat_specs.values())
    n = sum(v.numel() for v in _flatten(params).values())
    assert abs(n / 1e9 - cfg.params_billions()) / cfg.params_billions() < 0.05


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_struct_matches_reference(arch):
    cfg, ref = configs.get_config(arch), jconfigs.get_config(arch)
    pcfg, jpcfg = base.ParallelConfig(), jbase.ParallelConfig()
    shapes, axes = T.cache_struct(cfg, pcfg, 4, 4128)
    jshapes, jaxes = JT.cache_struct(ref, jpcfg, 4, 4128)

    def norm(tree):
        return [[{k: (tuple(s), _dt(d)) for k, (s, d) in _flatten(c).items()}
                 for c in stage] for stage in tree]

    assert norm(shapes) == norm(jshapes)
    assert [[_flatten(c) for c in st] for st in axes] == [
        [_flatten(c) for c in st] for st in jaxes]
    assert T.cache_axes(cfg, pcfg) == [
        tuple(st) for st in JT.cache_axes(ref, jpcfg)]
    meta = T.init_cache(cfg, pcfg, 4, 4128, abstract=True)
    jmeta = JT.init_cache(ref, jpcfg, 4, 4128, abstract=True)
    got = [[{k: (tuple(v.shape), _dt(v.dtype), v.device.type)
             for k, v in _flatten(c).items()} for c in st] for st in meta]
    assert got == [[{k: (tuple(v.shape), _dt(v.dtype), "meta")
                     for k, v in _flatten(c).items()} for c in st]
                   for st in jmeta]

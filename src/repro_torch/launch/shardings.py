"""Sharding resolution for whole program states (params / opt / batch /
cache); counterpart of ``repro.launch.shardings``.

Bridges the logical-axis spec trees produced by the model layer onto
``NamedSharding``s for a mesh, including the ZeRO-style optimizer-state
extension and the per-arch ``ParallelConfig`` defaults used by the dry run.
A state tree's leaves are tensors (on ``meta`` for an abstract state), or
anything with a ``.shape``; the result mirrors the logical-axes tree, whose
leaves are tuples of axis names and ``None``s.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.dist.sharding import (NamedSharding, P, resolve_spec,
                                       zero_fragment)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _map_axes(fn, axes, shapes):
    """``fn(axes_leaf, shapes_subtree)`` over the axes tree's leaves (the
    reference's ``jax.tree.map(fn, axes, shapes, is_leaf=_is_axes)``)."""
    if _is_axes(axes):
        return fn(axes, shapes)
    if isinstance(axes, dict):
        return {k: _map_axes(fn, v, shapes[k]) for k, v in axes.items()}
    if isinstance(axes, (list, tuple)):
        if len(axes) != len(shapes):
            raise ValueError(f"axes tree {axes!r} against {len(shapes)} "
                             f"shape subtrees")
        return type(axes)(_map_axes(fn, a, s) for a, s in zip(axes, shapes))
    raise TypeError(f"not a logical-axes tree: {axes!r}")


def shard_tree(shapes, axes, mesh, *, zero: bool = False):
    """NamedShardings for a (shape tree, logical-axes tree) pair."""

    def one(axes_leaf, shaped):
        spec = resolve_spec(axes_leaf, shaped.shape, mesh)
        if zero:
            spec = zero_fragment(spec, shaped.shape, mesh)
        return NamedSharding(mesh, spec)

    return _map_axes(one, axes, shapes)


def state_shardings(state_shapes, param_specs, mesh, *,
                    fsdp_params: bool = False):
    """Shardings for a TrainState {"params", "opt": {"m","v","step"}, "ef"?}."""
    params = shard_tree(state_shapes["params"], param_specs, mesh,
                        zero=fsdp_params)
    out = {"params": params, "opt": {}}
    sizes = dict(mesh.shape)

    def moment(axes_leaf, shaped):
        # fp32/bf16 moments mirror the param; int8 dict leaves handled below
        spec = resolve_spec(axes_leaf, shaped.shape, mesh)
        spec = zero_fragment(spec, shaped.shape, mesh)
        return NamedSharding(mesh, spec)

    def qshard(leaf):
        rows = leaf.shape[0]
        ax0 = ("data" if "data" in sizes and rows % sizes["data"] == 0
               else None)
        return NamedSharding(mesh, P(ax0, *([None] * (len(leaf.shape) - 1))))

    def walk(ax, sh):
        if isinstance(sh, dict) and "q" in sh:  # quantized moment
            return {k: qshard(v) for k, v in sh.items()}
        return moment(ax, sh)

    out["opt"]["m"] = _map_axes(walk, param_specs, state_shapes["opt"]["m"])
    out["opt"]["v"] = _map_axes(walk, param_specs, state_shapes["opt"]["v"])
    out["opt"]["step"] = NamedSharding(mesh, P())
    if "ef" in state_shapes:
        out["ef"] = shard_tree(state_shapes["ef"], param_specs, mesh,
                               zero=True)
    return out


# ---------------------------------------------------------------------------
# Banked-IRU shardings
# ---------------------------------------------------------------------------

def iru_partition_axis(mesh) -> str:
    """The mesh axis banked-IRU partitions shard over (its leading axis).

    The reference's banked engine and ``moe_hash_ep`` resolve the axis
    through this helper; the port's take ``n_shards``, the size of this
    axis (``mesh.shape[iru_partition_axis(mesh)]``).
    """
    return next(iter(mesh.shape))


# ---------------------------------------------------------------------------
# Per-arch parallel configuration (the dry run's defaults)
# ---------------------------------------------------------------------------

def default_pcfg(cfg: ModelConfig, shape: ShapeConfig,
                 mesh) -> ParallelConfig:
    """The reference's defaults, thresholds unchanged (they were set for the
    reference's 16 GB chips; the sweep's configurations stay comparable
    cell by cell)."""
    sizes = dict(mesh.shape)
    model_axis = sizes.get("model", 1)
    micro = 1
    if shape.kind == "train":
        # keep per-microbatch tokens ~<= 64k per data shard for MoE buffers
        data = sizes.get("data", 1) * sizes.get("pod", 1)
        tokens_per_shard = shape.global_batch * shape.seq_len // max(data, 1)
        if cfg.moe is not None:
            micro = max(1, tokens_per_shard // 32_768)
        elif cfg.d_model >= 6144:
            micro = max(1, tokens_per_shard // 65_536)
    # TP-sharded bf16 weights beyond ~8 GB a device -> shard params over
    # data too (FSDP)
    fsdp = cfg.params_billions() * 1e9 * 2 / model_axis > 8e9
    return ParallelConfig(
        model_axis=model_axis,
        remat="full" if shape.kind == "train" else "none",
        microbatches=micro,
        attn_chunk=2048 if shape.seq_len > 8192 else 1024,
        fsdp_params=fsdp,
    )

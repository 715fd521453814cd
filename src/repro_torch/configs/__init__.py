"""Architecture registry (counterpart of ``repro.configs``): full configs
and reduced smoke configs.

``get_config(name)``   -- the exact assigned configuration.
``smoke_config(name)`` -- same family/topology at toy width for CPU tests.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    deepseek_v2_lite_16b,
    granite_34b,
    grok_1_314b,
    jamba_1_5_large_398b,
    llava_next_34b,
    mamba2_130m,
    qwen3_32b,
    starcoder2_15b,
    starcoder2_7b,
    whisper_medium,
)
from repro_torch.configs.base import (
    LM_SHAPES,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    ParallelConfig,
    ShapeConfig,
    shape_applicable,
)

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        jamba_1_5_large_398b,
        starcoder2_7b,
        qwen3_32b,
        starcoder2_15b,
        granite_34b,
        llava_next_34b,
        whisper_medium,
        mamba2_130m,
        deepseek_v2_lite_16b,
        grok_1_314b,
    )
}

ARCH_IDS = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def smoke_config(name: str) -> ModelConfig:
    """Structurally faithful reduction: same family, pattern, attention type,
    MoE topology -- toy widths so a forward runs on the CPU."""
    cfg = get_config(name)
    unit = max(cfg.unit_len(), 1)
    n_layers = max(2 * unit, 2) if unit > 1 else 2
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, n_experts=min(moe.n_experts, 4), top_k=min(moe.top_k, 2), d_ff=64
        )
    mamba = cfg.mamba
    if mamba is not None:
        mamba = dataclasses.replace(mamba, d_state=16, head_dim=16, chunk=16)
    heads = 4 if cfg.n_heads else 0
    kv = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0
    if cfg.attention == "mla":
        kv = heads
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16 if heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_frames=24 if cfg.encoder_layers else cfg.encoder_frames,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        qk_rope_dim=8 if cfg.attention == "mla" else cfg.qk_rope_dim,
        moe=moe,
        mamba=mamba,
    )


__all__ = [
    "ARCH_IDS",
    "LM_SHAPES",
    "MambaConfig",
    "ModelConfig",
    "MoEConfig",
    "ParallelConfig",
    "REGISTRY",
    "ShapeConfig",
    "get_config",
    "shape_applicable",
    "smoke_config",
]

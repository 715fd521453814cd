"""Grok-1 (314B) [hf:xai-org/grok-1; unverified]: MoE 8e top-2, GQA kv=8."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    ffn_type="swiglu",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32768, layer_period=1),
    rope_theta=1e4,
    notes="8 experts on a 16-way model axis: TP-inside-expert mode (DESIGN.md §5).",
)

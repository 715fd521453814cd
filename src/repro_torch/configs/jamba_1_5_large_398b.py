"""Jamba-1.5-Large (398B): Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887 / 2408.12570; hf]. 72L, d_model 8192, 64H GQA kv=8,
d_ff 24576, vocab 65536.  MoE on every other layer; attention once per 8.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    ffn_type="swiglu",
    attention="gqa",
    layer_pattern=("attn",) + ("mamba",) * 7,   # 1:7 attn:mamba
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=24576, layer_period=2, layer_offset=1),
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
    rope_theta=1e6,
    notes="Mamba-2 block used where Jamba-1.5 ships Mamba-1 (DESIGN.md §2).",
)

"""Granite-34B-Code [arXiv:2405.04324; hf]: llama-arch, MQA (kv=1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,          # MQA: KV replicated across the model axis
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    ffn_type="gelu",
    rope_theta=1e5,
)

"""LLaVA-NeXT-34B backbone [hf:llava-hf; unverified]: VLM, anyres tiling.

Per the task spec the modality frontend is a STUB: ``input_specs`` provides
precomputed patch+text embeddings (frontend="embeds").
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,            # padded to 64 on a 16-way model axis (DESIGN.md §5)
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    ffn_type="swiglu",
    rope_theta=5e6,
    frontend="embeds",
)

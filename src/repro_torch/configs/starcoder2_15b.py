"""StarCoder2-15B [arXiv:2402.19173; hf]: dense, GQA kv=4, RoPE, gelu MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    ffn_type="gelu",
    rope_theta=1e5,
    attn_window=4096,      # sliding window (arXiv:2402.19173) -> sub-quadratic
)

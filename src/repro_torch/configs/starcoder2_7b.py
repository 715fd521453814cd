"""StarCoder2-7B [arXiv:2402.19173; hf]: dense, GQA kv=4, RoPE, gelu MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,           # padded to 48 on a 16-way model axis (DESIGN.md §5)
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    ffn_type="gelu",
    rope_theta=1e5,
    attn_window=4096,      # sliding window (arXiv:2402.19173) -> sub-quadratic
)

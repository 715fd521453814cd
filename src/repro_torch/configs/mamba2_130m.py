"""Mamba2-130M [arXiv:2405.21060; unverified]: attention-free SSD."""
from repro_torch.configs.base import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                 # attention-free, FFN-free (Mamba block only)
    vocab_size=50280,       # padded to 50432
    attention="none",
    layer_pattern=("mamba",),
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
    tie_embeddings=True,
)

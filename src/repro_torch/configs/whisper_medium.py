"""Whisper-medium [arXiv:2212.04356; unverified]: enc-dec, conv frontend stub.

24 encoder + 24 decoder layers, d_model 1024, 16H (kv=16 -> MHA), gelu MLP.
The conv/mel frontend is a STUB per spec: encoder input is precomputed frame
embeddings of length ``encoder_frames``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,            # decoder layers
    encoder_layers=24,
    encoder_frames=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,       # padded to 51968 for the 16-way model axis
    ffn_type="gelu",
    rope_theta=1e4,         # sinusoidal stand-in; whisper uses learned pos-emb
    frontend="embeds",
)

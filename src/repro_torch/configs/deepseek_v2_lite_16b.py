"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434; hf]: MLA kv_lora=512, MoE 64e top-6
+ 2 shared experts, first layer dense."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,          # MLA: all heads read the shared compressed KV
    head_dim=128,
    d_ff=10944,             # dense-FFN layers (layer 0)
    vocab_size=102400,
    ffn_type="swiglu",
    attention="mla",
    kv_lora_rank=512,
    qk_rope_dim=64,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_ff=1408,
        n_shared_experts=2,
        layer_period=1,
        first_dense_layers=1,
    ),
    rope_theta=1e4,
)

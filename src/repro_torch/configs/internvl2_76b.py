"""internvl2-76b [vlm] — InternLM2 backbone; InternViT frontend stubbed
(precomputed patch embeddings). [arXiv:2404.16821]"""
from .base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    d_head=128,
    rope_theta=1_000_000.0,
    mlp="swiglu",
    vlm=VLMConfig(n_patches=256),
    source="arXiv:2404.16821",
)

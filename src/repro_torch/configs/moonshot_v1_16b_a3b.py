"""moonshot-v1-16b-a3b (Moonlight) [moe] — 64 experts, top-6, softmax-then-topk.
[hf:moonshotai/Moonlight-16B-A3B]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    d_head=128,
    rope_theta=50_000.0,
    mlp="swiglu",
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, capacity_factor=1.25),
    source="hf:moonshotai/Moonlight-16B-A3B",
)

"""llama4-scout-17b-a16e [moe] — 16 routed experts, top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    d_head=128,
    rope_theta=500_000.0,
    mlp="swiglu",
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, capacity_factor=1.25),
    # H=40 cannot carry a 16-way TP axis; 2D TP (attention 8-way, EP 16-way)
    # with qkv fusion interleaved at 8 — EXPERIMENTS.md §Perf L1-L4
    tp_fuse=8,
    preferred_policy="tp2d",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

"""zamba2-1.2b [hybrid] — Mamba2 backbone + one shared attention+MLP block applied
every 6th layer (weights shared across invocations). [arXiv:2411.15242]"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    d_head=64,
    ssm=SSMConfig(d_state=64, d_head=64, expand=2, chunk=256),
    shared_attn_every=6,
    preferred_policy="fsdp",
    source="arXiv:2411.15242",
)

"""rwkv6-1.6b (Finch) [ssm] — attention-free, data-dependent decay. [arXiv:2404.05892]"""
from .base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # d_model / head_size(64)
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    d_head=64,
    rwkv=RWKVConfig(head_size=64, decay_lora=64, chunk=128),
    preferred_policy="fsdp",
    source="arXiv:2404.05892",
)

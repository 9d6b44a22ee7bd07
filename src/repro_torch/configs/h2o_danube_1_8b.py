"""h2o-danube-1.8b [dense] — llama+mistral mix, sliding-window attention. [arXiv:2401.16818]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    d_head=80,
    rope_theta=10_000.0,
    sliding_window=4096,
    mlp="swiglu",
    preferred_policy="fsdp",
    source="arXiv:2401.16818",
)

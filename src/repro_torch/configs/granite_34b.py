"""granite-34b [dense] — llama-arch, code model, MQA (kv=1). [arXiv:2405.04324]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    d_head=128,
    rope_theta=10_000.0,
    mlp="swiglu",
    source="arXiv:2405.04324",
)

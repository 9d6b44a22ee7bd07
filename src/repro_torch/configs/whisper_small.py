"""whisper-small [audio] — enc-dec; conv/mel frontend stubbed (precomputed frame
embeddings). GELU MLP, MHA (kv=12). [arXiv:2212.04356]"""
from .base import ModelConfig, EncoderConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,             # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    d_head=64,
    mlp="gelu",
    encoder=EncoderConfig(n_layers=12, enc_seq=1500),
    preferred_policy="fsdp",
    source="arXiv:2212.04356",
)

"""The language-model stack of the JAX package, in PyTorch: the dense, moe,
audio (whisper: encoder and cross-attention), vlm (patch embeddings), rwkv
and hybrid (zamba2) families with prefill, decode and their caches, on the
port's kernels (RMSNorm K4, flash attention K5, the Mamba-2 SSD scan K6 and
the RWKV-6 WKV scan K7), and their training forward and losses on
differentiable torch ops."""
from .model import (backbone_logits, cache_max_len, chunked_cross_entropy,
                    compute_model_dims, cross_entropy, forward_decode, forward_prefill,
                    forward_train, init_cache, init_params, lm_logits)
from .moe import init_moe, moe_mlp

__all__ = ["backbone_logits", "cache_max_len", "chunked_cross_entropy",
           "compute_model_dims", "cross_entropy", "forward_decode", "forward_prefill",
           "forward_train", "init_cache", "init_moe", "init_params",
           "lm_logits", "moe_mlp"]

"""The dense transformer model of the JAX package, in PyTorch, on the
port's RMSNorm (K4) and flash-attention (K5) kernels."""
from .model import backbone_logits, init_params, lm_logits

__all__ = ["backbone_logits", "init_params", "lm_logits"]

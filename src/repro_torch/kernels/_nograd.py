"""The kernels' refusal of inputs that carry a gradient.

A CUDA kernel here fills a fresh ``torch.empty`` through ctypes and has no
backward, so its output has no ``grad_fn``: a loss computed through it would
back-propagate nothing into what came before, and raise nothing. The
reference never trains through its Pallas kernels either (none has a
``custom_vjp``); its training path differentiates its XLA functions, and so
does the port's (``models.layers.rmsnorm_train``, ``attention_train``,
``models.mamba2.ssd_chunked_train``, ``models.rwkv6.wkv_chunked_train``).
Each wrapper calls :func:`refuse_grad` before it picks its device, so the
refusal holds on the CPU as on the card.
"""
from __future__ import annotations

from typing import Optional

import torch


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise ``RuntimeError`` naming the wrapper ``name`` when grad mode is
    on and any of ``tensors`` (``None`` skipped) requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and this kernel has no "
            f"backward; the model's training path does not run through the "
            f"kernel (call it under torch.no_grad() or "
            f"torch.inference_mode(), or train through repro_torch.models."
            f"forward_train)")

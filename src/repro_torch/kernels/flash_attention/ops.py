"""The model's layout: (B, S, H, Dh) in and out, the kernel's (B, H, S, Dh)
inside as strided views, so nothing is transposed in memory."""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: Optional[int] = None,
                       q_offset: int = 0) -> torch.Tensor:
    """q: (B, S, H, Dh); k, v: (B, S, KV, Dh) -- model-layer layout."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window,
                          q_offset=q_offset)
    return out.transpose(1, 2)

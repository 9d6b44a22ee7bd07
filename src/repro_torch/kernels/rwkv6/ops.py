"""The model's layout: (B, S, H, dh) in and out, the kernel's (B, H, S, dh)
inside as strided views, so nothing is transposed in memory."""
from __future__ import annotations

from typing import Optional

import torch

from .rwkv6 import wkv6_chunked


def wkv6_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, u: torch.Tensor, *, chunk: int,
            state: Optional[torch.Tensor] = None):
    """r, k, v, logw: (B, S, H, dh); u: (H, dh). Returns out (B, S, H, dh)
    f32 and the final state (B, H, dh, dh) f32."""
    out, state = wkv6_chunked(r.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), logw.transpose(1, 2), u,
                              chunk=chunk, state=state)
    return out.transpose(1, 2), state

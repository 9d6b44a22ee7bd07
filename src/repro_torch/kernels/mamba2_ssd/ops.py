"""The model's layout: x (B, S, H, dh) and lw (B, S, H) in, y (B, S, H, dh)
out, the kernel's (B, H, S, ...) inside as strided views, so nothing is
transposed in memory."""
from __future__ import annotations

from typing import Optional

import torch

from .mamba2_ssd import ssd_chunked


def ssd_chunked_op(x: torch.Tensor, lw: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, *, chunk: int,
                   state: Optional[torch.Tensor] = None):
    """x: (B, S, H, dh); lw: (B, S, H); Bm, Cm: (B, S, N). Returns y
    (B, S, H, dh) f32 and the final state (B, H, dh, N) f32."""
    y, state = ssd_chunked(x.transpose(1, 2), lw.transpose(1, 2), Bm, Cm,
                           chunk=chunk, state=state)
    return y.transpose(1, 2), state

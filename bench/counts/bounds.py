"""Least time (seconds) a kernel's call could take on an H100: every input
byte read once and every output byte written once at the HBM rate, against
the operations the call needs at the fastest rate the chip has for them on
any unit; the larger of the two. A kernel's roofline share is this bound
over its measured device time, so no implementation can read over 100 %.
"""
from __future__ import annotations

from .peaks import HBM_BYTES_PER_S, TF32_FLOPS


def ssd_bound(B: int, H: int, S: int, dh: int, N: int) -> float:
    """The Mamba-2 chunk scan (K6) over S steps from a given state, all in
    float32: x (B, S, H, dh) and lw (B, S, H) read, B and C (B, S, N) read,
    the entering state (B, H, dh, N) read; y (B, S, H, dh) and the final
    state written. The recurrence needs dh*N FMAs a step and head for the
    state and dh*N for y: 4 dh N flops, at the TF32 tensor rate (the
    fastest the chip has for float32 products)."""
    steps = B * H * S
    flops = 4.0 * steps * dh * N
    nbytes = 4 * (2 * steps * dh + steps + 2 * B * S * N + 2 * B * H * dh * N)
    return max(flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)

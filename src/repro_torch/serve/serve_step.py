"""Serving steps: batched prefill and single-token decode with KV/SSM
caches (``repro/serve/serve_step.py``)."""
from __future__ import annotations

import torch

from ..models import forward_decode, forward_prefill


def make_prefill_step(cfg, compute_dtype=torch.bfloat16):
    """prefill(params, batch) -> (last-token logits (B, V), cache)."""
    def prefill(params, batch):
        return forward_prefill(cfg, params, batch, compute_dtype)
    return prefill


def make_decode_step(cfg, compute_dtype=torch.bfloat16):
    """decode(params, cache, token (B,1), pos) -> (logits (B,1,V), cache)."""
    def decode(params, cache, token, pos):
        return forward_decode(cfg, params, cache, token, pos, compute_dtype)
    return decode


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """The first index of the largest logit, as int32 (ties go to the
    lower index in both frameworks)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)

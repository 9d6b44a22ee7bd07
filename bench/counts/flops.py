"""Operations a forward pass needs, from a configuration file's sizes (a
dict as ``bench/configs/<config>.json`` holds it).

Each count is the work the inputs need, whatever implements it: the
projections' and the head's products, attention over the S(S+1)/2 pairs a
causal mask keeps (not the masked S*S), and a Mamba-2 layer's scan as its
recurrence needs it (4 dh N flops a token and head). Elementwise work is
not counted. ``bench/test_bench_counts.py`` holds the projection and head
terms equal to ``repro_torch.analysis.flops.step_flops`` and the attention
and scan terms equal to its counts rescaled to the pairs and steps kept.
"""
from __future__ import annotations

from typing import Dict


def _dense_params(c) -> int:
    """Matmul parameters of one attention + SwiGLU block."""
    D, F = c["d_model"], c["d_ff"]
    H, KV, dh = c["n_heads"], c["n_kv_heads"], c["d_head"]
    return D * H * dh + 2 * D * KV * dh + H * dh * D + 3 * D * F


def _causal_attention(c, B: int, S: int) -> float:
    return 4.0 * B * c["n_heads"] * c["d_head"] * (S * (S + 1) // 2)


def _total(d: Dict[str, float]) -> Dict[str, float]:
    d["total"] = float(sum(d.values()))
    return d


def _hybrid_parts(c):
    s = c["ssm"]
    D = c["d_model"]
    di = s["expand"] * D
    Hm = di // s["d_head"]
    mamba = D * (2 * di + 2 * s["d_state"] + Hm) + di * D
    scan = 4 * Hm * s["d_head"] * s["d_state"]        # a token, a layer
    n_shared = c["n_layers"] // c["shared_attn_every"]
    return mamba, scan, n_shared


def hybrid_prefill(c, B: int, S: int) -> Dict[str, float]:
    """Zamba2's prefill of B prompts of S tokens: every Mamba-2 layer, the
    shared block at each of its calls, and the head at the last position."""
    L, D, V = c["n_layers"], c["d_model"], c["vocab_size"]
    mamba, scan, n_sh = _hybrid_parts(c)
    T = B * S
    return _total({"matmul": 2.0 * T * (L * mamba + n_sh * _dense_params(c)),
                   "scan": float(L * T * scan),
                   "attention": n_sh * _causal_attention(c, B, S),
                   "head": 2.0 * B * D * V})

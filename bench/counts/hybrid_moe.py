"""Operations a granitemoehybrid prefill needs, and K6's bounds in it, from
a configuration file's sizes (config.json's keys and ``n_layers``, as
``bench/configs/granite-4.0-h-small.json`` holds them).

Each count is the work the inputs need, whatever implements it: every
Mamba-2 layer's two projections and its scan as the recurrence needs it
(4 dh N flops a token and head); every attention layer's four
projections and the S(S+1)/2 pairs a causal mask keeps (not the masked
S*S); in every layer the router's product, the top-k routed experts'
three products a token (not all the experts') and the shared expert's;
the tied head at the last position. Elementwise work, the softmaxes, the
sort and the gathers are not counted. ``bench/test_bench_hybrid_moe.py``
holds each term equal to the plain reference's own products
(``torch.utils.flop_counter``), the attention and scan terms rescaled to
the pairs and steps kept.
"""
from __future__ import annotations

from typing import Dict

from .bounds import ssd_bound


def _mixers(c):
    return list(c["layer_types"][:c["n_layers"]])


def _widths(c):
    D = c["hidden_size"]
    return (D, c["mamba_expand"] * D, c["mamba_n_heads"], c["mamba_d_head"],
            c["mamba_d_state"])


def hybrid_moe_prefill(c, B: int, S: int) -> Dict[str, float]:
    """The prefill of B prompts of S tokens, by term (flops), with their
    ``total``."""
    D, di, H, dh, N = _widths(c)
    mix = _mixers(c)
    L, Lm, La = len(mix), mix.count("mamba"), mix.count("attention")
    Hq, KV = c["num_attention_heads"], c["num_key_value_heads"]
    ha = D // Hq
    E, k = c["num_local_experts"], c["num_experts_per_tok"]
    Fe, Fs = c["intermediate_size"], c["shared_intermediate_size"]
    T = B * S
    out = {"mamba": 2.0 * T * Lm * (D * (2 * di + 2 * N + H) + di * D),
           "scan": 4.0 * T * Lm * H * dh * N,
           "attention_proj": 2.0 * T * La * (2 * D * Hq * ha
                                             + 2 * D * KV * ha),
           "attention": 4.0 * B * La * Hq * ha * (S * (S + 1) // 2),
           "router": 2.0 * T * L * D * E,
           "experts": 2.0 * T * L * k * 3 * D * Fe,
           "shared": 2.0 * T * L * 3 * D * Fs,
           "head": 2.0 * B * D * c["vocab_size"]}
    out["total"] = float(sum(out.values()))
    return out


def ssd_bounds(c, S: int) -> float:
    """K6's least time (``bounds.ssd_bound``) over every Mamba-2 layer of
    one prompt of S tokens."""
    _, _, H, dh, N = _widths(c)
    return _mixers(c).count("mamba") * ssd_bound(1, H, S, dh, N)

"""Analytic per-step FLOP and HBM-traffic model, per (arch x shape): the
reference's count (``repro/analysis/flops.py``), copied so the port needs
nothing of ``repro``, and held equal to it on every cell.

The count follows the implemented algorithm, its inefficiencies included
(full masked S^2 attention, MoE capacity slots). It is the count of the
sharded algorithm the reference runs; the dry-run
(``launch/dryrun.py``) sets beside it what a rank of the port counts
(``FlopCounterMode``), which computes on whole weights.

Backward multipliers:
  matmul fwd F  ->  train total 4F   (bwd 2F + remat re-forward 1F)
  attention fwd -> train total 5F    (extra inner recompute: checkpointed
                                      _attend_block recomputes scores in bwd)
"""
from __future__ import annotations

from typing import Dict

from ..configs import ModelConfig, ShapeConfig


def _attn_flops(B, S, Sk, H, dh):
    """Full (unskipped) masked attention as implemented: QK^T + PV."""
    return 4.0 * B * H * S * Sk * dh


def _dense_layer_matmul_params(cfg) -> float:
    D, F = cfg.d_model, cfg.d_ff
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    attn = D * H * dh + 2 * D * KV * dh + H * dh * D
    kmlp = 3 if cfg.mlp == "swiglu" else 2
    return attn + kmlp * D * F


def step_flops(cfg: ModelConfig, shape: ShapeConfig, kind: str) -> Dict[str, float]:
    """Global (all-chip) FLOPs for one step of the implemented algorithm."""
    B = shape.global_batch
    S = shape.seq_len if kind in ("train", "prefill") else 1
    Sk = shape.seq_len                      # decode attends against the cache
    T = B * S                               # tokens processed
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    mm = 0.0      # matmul (param) flops, fwd
    at = 0.0      # attention score/value flops, fwd
    if cfg.rwkv is not None:
        r = cfg.rwkv
        proj = 5 * D * H * r.head_size + D * r.decay_lora + r.decay_lora * H * r.head_size
        cmix = D * cfg.d_ff + cfg.d_ff * D + D * D
        mm += L * T * 2 * (proj + cmix)
        # chunked wkv: decay (T'^2 dh) + scores + out + state terms per chunk
        C = r.chunk
        nc = max(S // C, 1) if S > 1 else 0
        if S > 1:
            at += L * B * cfg.n_heads * nc * (4 * C * C * r.head_size   # scores+out
                                              + 4 * C * r.head_size * r.head_size)
        else:
            at += L * B * cfg.n_heads * 4 * r.head_size * r.head_size
    elif cfg.family == "hybrid":
        s = cfg.ssm
        di = s.expand * D
        Hm = di // s.d_head
        mm += L * T * 2 * (D * (2 * di + 2 * s.d_state + Hm) + di * D)
        C = s.chunk
        nc = max(S // C, 1)
        if S > 1:
            at += L * B * (2 * C * C * s.d_state * nc            # CB
                           + 2 * Hm * C * C * s.d_head * nc      # intra y
                           + 4 * Hm * C * s.d_head * s.d_state * nc)  # state+inter
        else:
            at += L * B * Hm * 4 * s.d_head * s.d_state
        # shared attention block every Nth layer
        n_sh = L // cfg.shared_attn_every
        mm += n_sh * T * 2 * _dense_layer_matmul_params(cfg)
        at += n_sh * _attn_flops(B, S, Sk, H, dh)
    else:
        per_layer = D * H * dh + 2 * D * KV * dh + H * dh * D
        if cfg.moe is not None:
            m = cfg.moe
            # capacity-buffer expert matmuls (compute includes unfilled slots)
            cap_tokens = T * m.top_k * m.capacity_factor if S > 1 else B * m.n_experts
            mm += L * (T * 2 * per_layer + T * 2 * D * m.n_experts
                       + cap_tokens * 2 * 3 * D * m.d_ff_expert)
        else:
            mm += L * T * 2 * _dense_layer_matmul_params(cfg)
        win = cfg.sliding_window
        Sk_eff = min(Sk, win) if win else Sk
        S_eff = S if S > 1 else 1
        at += L * _attn_flops(B, S_eff, Sk_eff if S == 1 else min(S, Sk), H, dh)
        if cfg.encoder is not None and kind in ("train", "prefill"):
            Le, Se = cfg.encoder.n_layers, cfg.encoder.enc_seq
            mm += Le * B * Se * 2 * _dense_layer_matmul_params(cfg)
            at += Le * _attn_flops(B, Se, Se, H, dh)
            # decoder cross-attention
            mm += L * T * 2 * (D * H * dh + 2 * D * KV * dh + H * dh * D)
            at += L * _attn_flops(B, S, Se, H, dh)
        if cfg.vlm is not None:
            pass  # patch embeds are inputs; token count already covers S

    head = T * 2 * D * V                   # lm head
    loss = T * 5 * V if kind == "train" else 0.0

    if kind == "train":
        total = 4 * mm + 5 * at + 3 * head + loss   # head: fwd+bwd, no remat
    else:
        total = mm + at + head
    return {"matmul_fwd": mm, "attention_fwd": at, "head_fwd": head,
            "total": total}


def step_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, kind: str,
                   n_chips: int, tp: int = 16) -> float:
    """Per-chip HBM traffic estimate (bytes) for one step.

    Weight reads shard only by TP (each chip reads its 1/tp slice per matmul,
    regardless of FSDP, which gathers over ICI not HBM); activations,
    optimizer state and caches shard by all chips.

    train:   3x weight reads (fwd, remat, bwd) in bf16 + fp32 grads + 3x fp32
             optimizer state r/w + saved activations r/w
    prefill: 1x bf16 weights + cache write
    decode:  1x bf16 weights + full cache read + cache write
    """
    P = cfg.n_params()
    B, S = shape.global_batch, shape.seq_len
    D, L = cfg.d_model, cfg.n_layers
    if kind == "train":
        T = B * S
        weights = (3 * P * 2 + P * 4) / tp      # bf16 reads + fp32 grad write
        opt = 3 * P * 4 * 2 / n_chips           # m, v read+write; params rw
        acts = 2 * L * T * D * 2 * 2 / n_chips  # saved stack write+read (bf16)
        return weights + opt + acts
    if kind == "prefill":
        cache = 2 * L * B * S * cfg.n_kv_heads * cfg.d_head * 2
        return P * 2 / tp + (cache + B * S * D * 2 * L) / n_chips
    if True:  # decode
        if cfg.rwkv is not None:
            st = L * B * cfg.n_heads * cfg.rwkv.head_size ** 2 * 4
            cache_rw = 2 * st
        elif cfg.family == "hybrid":
            s = cfg.ssm
            di = s.expand * D
            st = L * B * (di // s.d_head) * s.d_head * s.d_state * 4
            n_sh = L // cfg.shared_attn_every
            Smax = S
            kv = 2 * n_sh * B * Smax * cfg.n_kv_heads * cfg.d_head * 2
            cache_rw = 2 * st + kv
        else:
            win = cfg.sliding_window
            Smax = min(S, win) if win else S
            kv = 2 * L * B * Smax * cfg.n_kv_heads * cfg.d_head * 2
            cache_rw = kv  # read whole cache, write one slot
        return P * 2 / tp + cache_rw / n_chips

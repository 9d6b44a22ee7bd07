"""The dense transformer stack of ``repro/models/model.py``, in PyTorch.

Parameters keep the reference's layout: a dict whose ``layers`` entry holds
each weight stacked over layers, ``(L, ...)``, so
``repro_torch.convert.from_jax`` carries the reference's weights across
with no renaming. The reference scans the stack; here the scan is a Python
loop over layer slices. Only the ``dense`` family is ported: the others
(moe, ssm, hybrid, audio, vlm) join with the language-model-stack slice
(ROADMAP Queue 1 item 7), and so do prefill, decode and the losses.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .layers import (apply_rope, attention, attn_out, attn_qkv, init_attn,
                     init_mlp, mlp, normal_init, rmsnorm)

Params = Dict[str, Any]


def _dense_only(cfg):
    if cfg.family != "dense" or cfg.moe is not None \
            or cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; it "
            f"joins with the language-model-stack slice (ROADMAP Queue 1 "
            f"item 7)")


def init_params(cfg, gen: torch.Generator, dtype=torch.float32,
                device=None) -> Params:
    """Weights of a dense config, drawn from ``gen`` (a CPU generator: one
    seed gives the same weights on every device) and placed on ``device``."""
    _dense_only(cfg)
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    kw = dict(dtype=dtype, device=device)
    params: Params = {"embed": {"tok": normal_init(gen, (V, D), **kw)},
                      "final_norm": torch.ones((D,), **kw)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (D, V), **kw)
    params["layers"] = {
        "ln1": torch.ones((L, D), **kw),
        "attn": init_attn(gen, cfg, L, **kw),
        "ln2": torch.ones((L, D), **kw),
        "mlp": init_mlp(gen, D, cfg.d_ff, cfg.mlp, L, cfg.n_layers, **kw),
    }
    return params


def lm_logits(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"]["tok"].T if cfg.tie_embeddings \
        else params["lm_head"]
    return x @ head.to(x.dtype)


def _layer(tree, i: int):
    """Layer ``i`` of a tree of stacked ``(L, ...)`` tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _txf_layer(cfg, x: torch.Tensor, lp: Params,
               positions: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn_qkv(h, lp["attn"], cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=True, window=cfg.sliding_window)
    x = x + attn_out(o, lp["attn"])
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(h, lp["mlp"], cfg.mlp, cfg.tp_fuse)


def _txf_stack(cfg, params: Params, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) through every layer of ``params["layers"]``; positions
    (S,). The reference's ``_txf_stack`` without remat, KV cache or
    encoder, which the dense forward does not use."""
    _dense_only(cfg)
    for i in range(params["layers"]["ln1"].shape[0]):
        x = _txf_layer(cfg, x, _layer(params["layers"], i), positions)
    return x


def backbone_logits(cfg, params: Params, x: torch.Tensor,
                    positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense backbone's forward: x (B, S, D) through every layer, the
    final rmsnorm and the head, giving logits (B, S, vocab) in x's dtype.
    Positions default to ``0 .. S-1``."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    x = _txf_stack(cfg, params, x, positions)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, x)

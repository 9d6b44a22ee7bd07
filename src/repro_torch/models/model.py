"""The language-model stack of ``repro/models/model.py``, in PyTorch: the
dense, rwkv (``ssm``) and hybrid (zamba2: Mamba-2 layers plus one shared
attention block) families, with prefill, decode and their caches.

Parameters keep the reference's layout: a dict whose ``layers`` entry holds
each weight stacked over layers, ``(L, ...)`` (``layers.rwkv``,
``layers.mamba``, and ``shared`` for the hybrid's one shared block), so
``repro_torch.convert.from_jax`` carries the reference's weights and caches
across with no renaming. The reference scans the stack; here the scan is a
Python loop over layer slices, and its ``jax.lax.cond`` an ``if`` on the
layer index. The moe, audio and vlm families, training and the losses wait
for a later slice (ROADMAP) and raise ``NotImplementedError``.

Caches:
  * dense:   ``{"k","v": (L, B, Smax, KV, Dh)}``; sliding-window configs a
    ring of length ``window``.
  * rwkv6:   ``{shift, wkv, cshift}`` stacked over L (O(1) in sequence).
  * hybrid:  ``{"state": {ssm, conv}}`` stacked over L, plus the shared
    block's ``"k","v": (n_slots, B, Smax, KV, Dh)``.
``forward_decode`` writes the new token's K/V into the cache tensors in
place (a functional update would copy the whole cache per token) and
returns new recurrent states.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..device import resolve_device
from . import mamba2 as mamba_mod
from . import rwkv6 as rwkv_mod
from .layers import (apply_rope, attention, attn_out, attn_qkv,
                     decode_attention, init_attn, init_mlp, mlp, normal_init,
                     rmsnorm)

Params = Dict[str, Any]


def _kind(cfg) -> str:
    """'rwkv', 'hybrid' or 'dense'; the families of later slices raise."""
    if cfg.family == "ssm" and cfg.rwkv is not None:
        return "rwkv"
    if cfg.family == "hybrid":
        return "hybrid"
    if cfg.family == "dense" and cfg.moe is None and cfg.encoder is None \
            and cfg.vlm is None:
        return "dense"
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family} family is not ported yet; it joins "
        f"with a later slice (ROADMAP Queue 1)")


def init_params(cfg, gen: torch.Generator, dtype=torch.float32,
                device=None) -> Params:
    """Weights drawn from ``gen`` (a CPU generator: one seed gives the same
    weights on every device) and placed on ``device`` (``None``: ``cuda``,
    an error without a card)."""
    kind = _kind(cfg)
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    kw = dict(dtype=dtype, device=resolve_device(device))
    params: Params = {"embed": {"tok": normal_init(gen, (V, D), **kw)},
                      "final_norm": torch.ones((D,), **kw)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (D, V), **kw)
    if kind == "rwkv":
        params["layers"] = {"rwkv": rwkv_mod.init_rwkv_layer(gen, cfg, L,
                                                             **kw)}
    elif kind == "hybrid":
        params["layers"] = {"mamba": mamba_mod.init_mamba_layer(gen, cfg, L,
                                                                **kw)}
        params["shared"] = {
            "ln1": torch.ones((D,), **kw),
            "attn": init_attn(gen, cfg, None, **kw),
            "ln2": torch.ones((D,), **kw),
            "mlp": init_mlp(gen, D, cfg.d_ff, cfg.mlp, None, cfg.n_layers,
                            **kw),
        }
    else:
        params["layers"] = {
            "ln1": torch.ones((L, D), **kw),
            "attn": init_attn(gen, cfg, L, **kw),
            "ln2": torch.ones((L, D), **kw),
            "mlp": init_mlp(gen, D, cfg.d_ff, cfg.mlp, L, cfg.n_layers,
                            **kw),
        }
    return params


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(cfg, params: Params, tokens: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    return params["embed"]["tok"][tokens].to(compute_dtype)


def lm_logits(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"]["tok"].T if cfg.tie_embeddings \
        else params["lm_head"]
    return x @ head.to(x.dtype)


def _layer(tree, i: int):
    """Layer ``i`` of a tree of stacked ``(L, ...)`` tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees):
    """Stack a list of same-shaped trees along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# dense transformer stack
# ---------------------------------------------------------------------------

def _txf_layer(cfg, x: torch.Tensor, lp: Params, positions: torch.Tensor):
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn_qkv(h, lp["attn"], cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=True, window=cfg.sliding_window)
    x = x + attn_out(o, lp["attn"])
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(h, lp["mlp"], cfg.mlp, cfg.tp_fuse), (k, v)


def _txf_stack(cfg, params: Params, x: torch.Tensor, positions: torch.Tensor,
               *, collect_cache: bool = False):
    """x: (B, S, D) through every layer of ``params["layers"]``; positions
    (S,). Returns (x, cache or None), the cache ``{"k","v": (L, B, S, KV,
    Dh)}`` when ``collect_cache``."""
    if _kind(cfg) != "dense":
        raise ValueError(f"{cfg.name} is not a dense config")
    ks, vs = [], []
    for i in range(params["layers"]["ln1"].shape[0]):
        x, (k, v) = _txf_layer(cfg, x, _layer(params["layers"], i),
                               positions)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} \
        if collect_cache else None
    return x, cache


def _txf_decode(cfg, params: Params, x: torch.Tensor, cache, pos: int):
    """Single-token decode through the stack, writing the KV cache."""
    window = cfg.sliding_window
    Smax = cache["k"].shape[2]
    write_pos = pos % Smax if window is not None else pos
    rope_pos = torch.tensor([pos], device=x.device)
    for i in range(params["layers"]["ln1"].shape[0]):
        lp = _layer(params["layers"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(h, lp["attn"], cfg)
        q = apply_rope(q, rope_pos, cfg.rope_theta)
        k = apply_rope(k, rope_pos, cfg.rope_theta)
        kc[:, write_pos] = k[:, 0].to(kc.dtype)
        vc[:, write_pos] = v[:, 0].to(vc.dtype)
        o = decode_attention(q, kc, vc, pos, window=window)
        x = x + attn_out(o, lp["attn"])
        h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp(h, lp["mlp"], cfg.mlp, cfg.tp_fuse)
    return x, cache


def backbone_logits(cfg, params: Params, x: torch.Tensor,
                    positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense backbone's forward: x (B, S, D) through every layer, the
    final rmsnorm and the head, giving logits (B, S, vocab) in x's dtype.
    Positions default to ``0 .. S-1``."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _txf_stack(cfg, params, x, positions)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, x)


# ---------------------------------------------------------------------------
# rwkv / hybrid stacks
# ---------------------------------------------------------------------------

def _rwkv_stack(cfg, params: Params, x: torch.Tensor, state):
    """Every rwkv layer in turn; returns (x, the new stacked state)."""
    new = []
    for i in range(params["layers"]["rwkv"]["ln1"].shape[0]):
        x, st = rwkv_mod.rwkv_block(x, _layer(params["layers"]["rwkv"], i),
                                    cfg, _layer(state, i))
        new.append(st)
    return x, _stack(new)


def _shared_block(cfg, sp: Params, x: torch.Tensor, positions: torch.Tensor):
    h = rmsnorm(x, sp["ln1"], cfg.norm_eps)
    q, k, v = attn_qkv(h, sp["attn"], cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    x = x + attn_out(attention(q, k, v, causal=True), sp["attn"])
    h = rmsnorm(x, sp["ln2"], cfg.norm_eps)
    return x + mlp(h, sp["mlp"], cfg.mlp, cfg.tp_fuse), (k, v)


def _hybrid_stack(cfg, params: Params, x: torch.Tensor, state,
                  positions: torch.Tensor, *, collect_cache: bool = False):
    """Zamba2: the Mamba2 layers in turn; the shared attention block after
    every ``shared_attn_every``-th. Returns (x, new stacked state, cache or
    None); the cache holds the K/V of the ``n_layers // every`` slots where
    the shared block ran, (n_slots, B, S, KV, Dh), as the reference's
    ``nonzero(flags, size=n_slots)`` selects them."""
    every = cfg.shared_attn_every
    n_slots = cfg.n_layers // every
    sp = params["shared"]
    new, ks, vs = [], [], []
    for i in range(params["layers"]["mamba"]["ln"].shape[0]):
        x, st = mamba_mod.mamba_block(x, _layer(params["layers"]["mamba"], i),
                                      cfg, _layer(state, i))
        new.append(st)
        if i % every == every - 1:
            x, (k, v) = _shared_block(cfg, sp, x, positions)
            ks.append(k)
            vs.append(v)
    cache = None
    if collect_cache:
        cache = {"k": torch.stack(ks[:n_slots]),
                 "v": torch.stack(vs[:n_slots])}
    return x, _stack(new), cache


def _hybrid_decode(cfg, params: Params, x: torch.Tensor, cache, pos: int):
    every = cfg.shared_attn_every
    sp = params["shared"]
    rope_pos = torch.tensor([pos], device=x.device)
    kc_all, vc_all = cache["k"], cache["v"]          # (n_slots, B, Smax, ..)
    new = []
    for i in range(params["layers"]["mamba"]["ln"].shape[0]):
        x, st = mamba_mod.mamba_block(x, _layer(params["layers"]["mamba"], i),
                                      cfg, _layer(cache["state"], i))
        new.append(st)
        if i % every == every - 1:
            kc, vc = kc_all[i // every], vc_all[i // every]
            h = rmsnorm(x, sp["ln1"], cfg.norm_eps)
            q, k, v = attn_qkv(h, sp["attn"], cfg)
            q = apply_rope(q, rope_pos, cfg.rope_theta)
            k = apply_rope(k, rope_pos, cfg.rope_theta)
            kc[:, pos] = k[:, 0].to(kc.dtype)
            vc[:, pos] = v[:, 0].to(vc.dtype)
            o = decode_attention(q, kc, vc, pos)
            x = x + attn_out(o, sp["attn"])
            h = rmsnorm(x, sp["ln2"], cfg.norm_eps)
            x = x + mlp(h, sp["mlp"], cfg.mlp, cfg.tp_fuse)
    return x, {"k": kc_all, "v": vc_all, "state": _stack(new)}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def forward_prefill(cfg, params: Params, batch, compute_dtype=torch.bfloat16):
    """Process a full prompt, ``batch["tokens"]`` (B, S); returns
    (last-token logits (B, V), cache)."""
    kind = _kind(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens, compute_dtype)
    B, S = tokens.shape
    dev = x.device
    positions = torch.arange(S, device=dev)
    if kind == "rwkv":
        state = rwkv_mod.init_rwkv_state(cfg, B, compute_dtype, dev)
        x, cache = _rwkv_stack(cfg, params, x, state)
    elif kind == "hybrid":
        state = mamba_mod.init_mamba_state(cfg, cfg.n_layers, B,
                                           compute_dtype, dev)
        x, state, kv = _hybrid_stack(cfg, params, x, state, positions,
                                     collect_cache=True)
        cache = {"state": state, **kv}
    else:
        x, cache = _txf_stack(cfg, params, x, positions, collect_cache=True)
    x = rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, x)[:, 0], cache


def forward_decode(cfg, params: Params, cache, token: torch.Tensor, pos: int,
                   compute_dtype=torch.bfloat16):
    """One decode step. token: (B, 1); pos: the position being written.
    Returns (logits (B, 1, V), new cache)."""
    kind = _kind(cfg)
    x = embed_tokens(cfg, params, token, compute_dtype)
    pos = int(pos)
    if kind == "rwkv":
        x, new_cache = _rwkv_stack(cfg, params, x, cache)
    elif kind == "hybrid":
        x, new_cache = _hybrid_decode(cfg, params, x, cache, pos)
    else:
        x, new_cache = _txf_decode(cfg, params, x, cache, pos)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, x), new_cache


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def cache_max_len(cfg, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
               device=None):
    """Zero cache sized for decoding up to seq_len, on ``device``
    (``None``: ``cuda``)."""
    kind = _kind(cfg)
    dev = resolve_device(device)
    if kind == "rwkv":
        return rwkv_mod.init_rwkv_state(cfg, batch, dtype, dev)
    Smax = cache_max_len(cfg, seq_len)
    KV, Dh = cfg.n_kv_heads, cfg.d_head
    kw = dict(dtype=dtype, device=dev)
    if kind == "hybrid":
        n_slots = cfg.n_layers // cfg.shared_attn_every
        return {
            "state": mamba_mod.init_mamba_state(cfg, cfg.n_layers, batch,
                                                dtype, dev),
            "k": torch.zeros((n_slots, batch, Smax, KV, Dh), **kw),
            "v": torch.zeros((n_slots, batch, Smax, KV, Dh), **kw),
        }
    L = cfg.n_layers
    return {"k": torch.zeros((L, batch, Smax, KV, Dh), **kw),
            "v": torch.zeros((L, batch, Smax, KV, Dh), **kw)}

"""The language-model stack of ``repro/models/model.py``, in PyTorch: every
family of the reference (dense, moe, audio and vlm transformers; rwkv,
``ssm``; and hybrid, zamba2: Mamba-2 layers plus one shared attention
block), with prefill, decode, their caches and the training forward.

Parameters keep the reference's layout: a dict whose ``layers`` entry holds
each weight stacked over layers, ``(L, ...)`` (``layers.rwkv``,
``layers.mamba``, ``layers.moe`` in place of ``layers.mlp``,
``layers.xattn``, and ``shared`` for the hybrid's one shared block,
``encoder`` and ``pos_emb`` for whisper), so ``repro_torch.convert.from_jax``
carries the reference's weights and caches across with no renaming. The
reference scans the stack; here the scan is a Python loop over layer
slices, and its ``jax.lax.cond`` an ``if`` on the layer index.

The transformer families differ by branches inside one stack, as in the
reference: moe layers route through ``moe.moe_mlp`` and add its aux loss;
audio (whisper) runs a non-causal encoder over precomputed frame
embeddings, scales token embeddings by sqrt(d), adds learned positions in
place of RoPE and cross-attends to the encoder in every decoder layer; vlm
prepends precomputed patch embeddings (``batch["embeds"]``), so positions
run over n_patches + S.

Training (``forward_train``, the losses) runs the stacks with ``train=True``:
the differentiable counterparts of the reference's XLA functions in place of
the kernels K4-K7, which have no backward (and refuse an input that requires
grad). ``remat=True`` puts each layer under ``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` of its scan body.

Caches:
  * transformer: ``{"k","v": (L, B, Smax, KV, Dh)}``; sliding-window
    configs a ring of length ``window``; audio adds the encoder's
    cross-attention ``{"ck","cv": (L, B, enc_seq, KV, Dh)}``.
  * rwkv6:   ``{shift, wkv, cshift}`` stacked over L (O(1) in sequence).
  * hybrid:  ``{"state": {ssm, conv}}`` stacked over L, plus the shared
    block's ``"k","v": (n_slots, B, Smax, KV, Dh)``.
``forward_decode`` writes the new token's K/V into the cache tensors in
place (a functional update would copy the whole cache per token) and
returns new recurrent states.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..device import resolve_init_device
from . import mamba2 as mamba_mod
from . import rwkv6 as rwkv_mod
from .layers import (apply_rope, attention, attention_train, attn_out,
                     attn_qkv, checkpointed, decode_attention, init_attn,
                     init_mlp, mlp, normal_init, rmsnorm, rmsnorm_train,
                     upcast)
from .moe import init_moe, moe_mlp

Params = Dict[str, Any]


def _kind(cfg) -> str:
    """'rwkv', 'hybrid' or 'transformer' (dense, moe, audio and vlm), as
    the reference's branches test them."""
    if cfg.family == "ssm" and cfg.rwkv is not None:
        return "rwkv"
    if cfg.family == "hybrid":
        return "hybrid"
    return "transformer"


def init_params(cfg, gen: torch.Generator, dtype=torch.float32,
                device=None) -> Params:
    """Weights drawn from ``gen`` (a CPU generator: one seed gives the same
    weights on every device) and placed on ``device`` (``None``: ``cuda``,
    an error without a card)."""
    kind = _kind(cfg)
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    kw = dict(dtype=dtype, device=resolve_init_device(device))
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
        layers = {"ln1": torch.ones((L, D), **kw),
                  "attn": init_attn(gen, cfg, L, **kw),
                  "ln2": torch.ones((L, D), **kw)}
        if cfg.moe is not None:
            layers["moe"] = init_moe(gen, cfg, L, **kw)
        else:
            layers["mlp"] = init_mlp(gen, D, cfg.d_ff, cfg.mlp, L,
                                     cfg.n_layers, **kw)
        if cfg.encoder is not None:     # whisper: cross-attention, encoder
            layers["xattn"] = init_attn(gen, cfg, L, **kw)
            Le = cfg.encoder.n_layers
            params["encoder"] = {
                "layers": {"ln1": torch.ones((Le, D), **kw),
                           "attn": init_attn(gen, cfg, Le, **kw),
                           "ln2": torch.ones((Le, D), **kw),
                           "mlp": init_mlp(gen, D, cfg.d_ff, cfg.mlp, Le,
                                           cfg.n_layers, **kw)},
                "final_norm": torch.ones((D,), **kw)}
            params["pos_emb"] = normal_init(
                gen, (min(cfg.max_seq, 32_768), D), 0.01, **kw)
        params["layers"] = layers
    return params


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(cfg, params: Params, tokens: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    x = params["embed"]["tok"][tokens].to(compute_dtype)
    if cfg.family != "audio":
        return x
    # sqrt(d) rounded to x's dtype first, as JAX rounds a Python scalar
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)


def _build_inputs(cfg, params: Params, batch, compute_dtype) -> torch.Tensor:
    """Token embeddings, with the vlm's patch embeddings
    (``batch["embeds"]``, (B, n_patches, D)) prepended."""
    dev = params["embed"]["tok"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    x = embed_tokens(cfg, params, tokens, compute_dtype)
    if cfg.vlm is not None and "embeds" in batch:
        x = torch.cat([torch.as_tensor(batch["embeds"], device=dev)
                       .to(compute_dtype), x], dim=1)
    return x


def _encoder_inputs(cfg, params: Params, batch, x: torch.Tensor,
                    compute_dtype, train: bool = False):
    """For an encoder config: the encoder's output over
    ``batch["enc_embeds"]`` and ``x`` with the learned positions
    ``pos_emb[:S]`` added; else (None, x)."""
    if cfg.encoder is None:
        return None, x
    enc = torch.as_tensor(batch["enc_embeds"], device=x.device)
    enc_out = _encoder_forward(cfg, params, enc, compute_dtype, train)
    return enc_out, x + params["pos_emb"][:x.shape[1]].to(compute_dtype)


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
# transformer stack (dense, moe, audio decoder and encoder, vlm)
# ---------------------------------------------------------------------------

def _ops(train: bool):
    """(rmsnorm, attention): the kernels K4 and K5, or for training their
    differentiable counterparts."""
    return (rmsnorm_train, attention_train) if train else (rmsnorm, attention)


def _ffn(cfg, h: torch.Tensor, lp: Params):
    """The layer's MLP, or its MoE and that layer's aux loss (else None)."""
    if "moe" in lp:
        return moe_mlp(h, lp["moe"], cfg)
    return mlp(h, lp["mlp"], cfg.mlp, cfg.tp_fuse), None


def _txf_layer(cfg, x: torch.Tensor, lp: Params, positions: torch.Tensor,
               enc_out: Optional[torch.Tensor] = None, train: bool = False):
    """One decoder layer (``model.py:140``). Returns (x, the layer's aux
    loss or None, its cache entries: (k, v), and with ``enc_out`` also the
    cross-attention's (kx, vx))."""
    norm, attend = _ops(train)
    h = norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn_qkv(h, lp["attn"], cfg)
    if cfg.family != "audio":       # audio: learned positions, no RoPE
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = attend(q, k, v, causal=True, window=cfg.sliding_window)
    x = x + attn_out(o, lp["attn"])
    kv = (k, v)
    if enc_out is not None:
        # normed with ln2, which the MLP's norm below uses again: the
        # reference's init makes no "ln_x" for its ``"ln_x" in lp`` test
        # (ROADMAP Queue 3, R10)
        h = norm(x, lp["ln2"], cfg.norm_eps)
        qx = attn_qkv(h, lp["xattn"], cfg)[0]
        _, kx, vx = attn_qkv(enc_out, lp["xattn"], cfg)
        x = x + attn_out(attend(qx, kx, vx, causal=False), lp["xattn"])
        kv = kv + (kx, vx)
    y, aux = _ffn(cfg, norm(x, lp["ln2"], cfg.norm_eps), lp)
    return x + y, aux, kv


def _encoder_forward(cfg, params: Params, enc_embeds: torch.Tensor,
                     compute_dtype, train: bool = False) -> torch.Tensor:
    """Whisper's encoder (``model.py:168``) over precomputed frame
    embeddings (B, enc_seq, D): non-causal self-attention, the MLP, and
    its own final norm."""
    norm, attend = _ops(train)
    x = enc_embeds.to(compute_dtype)
    lps = params["encoder"]["layers"]
    for i in range(lps["ln1"].shape[0]):
        lp = _layer(lps, i)
        h = norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(h, lp["attn"], cfg)
        x = x + attn_out(attend(q, k, v, causal=False), lp["attn"])
        h = norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp(h, lp["mlp"], cfg.mlp, cfg.tp_fuse)
    return norm(x, params["encoder"]["final_norm"], cfg.norm_eps)


def _txf_stack(cfg, params: Params, x: torch.Tensor, positions: torch.Tensor,
               enc_out: Optional[torch.Tensor] = None, *,
               remat: bool = False, train: bool = False,
               collect_cache: bool = False):
    """x: (B, S, D) through every layer of ``params["layers"]``; positions
    (S,); ``enc_out`` the encoder's output for cross-attention (audio).
    Returns (x, the layers' summed aux loss (f32; f64 for f64 compute),
    cache or None), the cache ``{"k","v": (L, B, S, KV, Dh)}`` (and
    ``"ck","cv": (L, B, enc_seq, KV, Dh)`` with ``enc_out``) when
    ``collect_cache``. ``train``: the differentiable ops; ``remat``: each
    layer under ``torch.utils.checkpoint``."""
    if _kind(cfg) != "transformer":
        raise ValueError(f"{cfg.name} is not a transformer config")
    aux = torch.zeros((), dtype=torch.promote_types(x.dtype, torch.float32),
                      device=x.device)
    kvs = []

    def layer(x, lp):
        return _txf_layer(cfg, x, lp, positions, enc_out, train)
    for i in range(params["layers"]["ln1"].shape[0]):
        lp = _layer(params["layers"], i)
        x, a, kv = checkpointed(layer, x, lp) if remat else layer(x, lp)
        if a is not None:
            aux = aux + a
        if collect_cache:
            kvs.append(kv)
    cache = None
    if collect_cache:
        cache = dict(zip(("k", "v", "ck", "cv"),
                         (torch.stack(t) for t in zip(*kvs))))
    return x, aux, cache


def _txf_decode(cfg, params: Params, x: torch.Tensor, cache, pos: int):
    """Single-token decode through the stack, writing the KV cache; with
    the encoder's ``ck``/``cv`` in the cache, each layer also
    cross-attends to all of it."""
    window = cfg.sliding_window
    Smax = cache["k"].shape[2]
    write_pos = pos % Smax if window is not None else pos
    rope_pos = torch.tensor([pos], device=x.device)
    for i in range(params["layers"]["ln1"].shape[0]):
        lp = _layer(params["layers"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(h, lp["attn"], cfg)
        if cfg.family != "audio":
            q = apply_rope(q, rope_pos, cfg.rope_theta)
            k = apply_rope(k, rope_pos, cfg.rope_theta)
        kc[:, write_pos] = k[:, 0].to(kc.dtype)
        vc[:, write_pos] = v[:, 0].to(vc.dtype)
        o = decode_attention(q, kc, vc, pos, window=window)
        x = x + attn_out(o, lp["attn"])
        if "ck" in cache:
            ck, cv = cache["ck"][i], cache["cv"][i]
            h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
            qx = attn_qkv(h, lp["xattn"], cfg)[0]
            x = x + attn_out(decode_attention(qx, ck, cv, ck.shape[1] - 1),
                             lp["xattn"])
        y, _ = _ffn(cfg, rmsnorm(x, lp["ln2"], cfg.norm_eps), lp)
        x = x + y
    return x, cache


def backbone_logits(cfg, params: Params, x: torch.Tensor,
                    positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense backbone's forward: x (B, S, D) through every layer, the
    final rmsnorm and the head, giving logits (B, S, vocab) in x's dtype.
    Positions default to ``0 .. S-1``."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    x, _, _ = _txf_stack(cfg, params, x, positions)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, x)


# ---------------------------------------------------------------------------
# rwkv / hybrid stacks
# ---------------------------------------------------------------------------

def _rwkv_stack(cfg, params: Params, x: torch.Tensor, state, *,
                remat: bool = False, train: bool = False):
    """Every rwkv layer in turn; returns (x, the new stacked state)."""
    new = []

    def layer(x, lp, st):
        return rwkv_mod.rwkv_block(x, lp, cfg, st, train)
    for i in range(params["layers"]["rwkv"]["ln1"].shape[0]):
        args = (x, _layer(params["layers"]["rwkv"], i), _layer(state, i))
        x, st = checkpointed(layer, *args) if remat else layer(*args)
        new.append(st)
    return x, _stack(new)


def _shared_block(cfg, sp: Params, x: torch.Tensor, positions: torch.Tensor,
                  train: bool = False):
    norm, attend = _ops(train)
    h = norm(x, sp["ln1"], cfg.norm_eps)
    q, k, v = attn_qkv(h, sp["attn"], cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    x = x + attn_out(attend(q, k, v, causal=True), sp["attn"])
    h = norm(x, sp["ln2"], cfg.norm_eps)
    return x + mlp(h, sp["mlp"], cfg.mlp, cfg.tp_fuse), (k, v)


def _hybrid_layer(cfg, x, lp, st, sp, positions, shared: bool,
                  train: bool):
    """One Mamba2 layer, then the shared block if ``shared``. Returns (x,
    new state, the shared block's (k, v) or None)."""
    x, st = mamba_mod.mamba_block(x, lp, cfg, st, train)
    kv = None
    if shared:
        x, kv = _shared_block(cfg, sp, x, positions, train)
    return x, st, kv


def _hybrid_stack(cfg, params: Params, x: torch.Tensor, state,
                  positions: torch.Tensor, *, remat: bool = False,
                  train: bool = False, collect_cache: bool = False):
    """Zamba2: the Mamba2 layers in turn; the shared attention block after
    every ``shared_attn_every``-th. Returns (x, new stacked state, cache or
    None); the cache holds the K/V of the ``n_layers // every`` slots where
    the shared block ran, (n_slots, B, S, KV, Dh), as the reference's
    ``nonzero(flags, size=n_slots)`` selects them. ``train`` and ``remat``
    as for the dense stack (a layer with its shared block is one
    checkpoint)."""
    every = cfg.shared_attn_every
    n_slots = cfg.n_layers // every
    sp = params["shared"]
    new, ks, vs = [], [], []

    def layer(x, lp, st, shared):
        return _hybrid_layer(cfg, x, lp, st, sp, positions, shared, train)
    for i in range(params["layers"]["mamba"]["ln"].shape[0]):
        args = (x, _layer(params["layers"]["mamba"], i), _layer(state, i),
                i % every == every - 1)
        x, st, kv = checkpointed(layer, *args) if remat else layer(*args)
        new.append(st)
        if kv is not None:
            k, v = kv
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

def forward_train(cfg, params: Params, batch, compute_dtype=torch.bfloat16,
                  remat: bool = True):
    """The reference's ``forward_train`` (``repro/models/model.py:372``):
    the per-token mean loss and its metrics (``loss``, ``acc``, ``tokens``;
    moe adds ``aux_loss``) over ``batch["tokens"]`` and ``batch["targets"]``
    (tensors, or arrays moved to the params' device), -100 targets masked;
    with ``batch["embeds"]`` (vlm, prepended) or ``batch["enc_embeds"]``
    (audio, the encoder's input). The targets cover every position, patches
    included. Moe adds ``router_aux_weight * aux / n_layers`` to the loss.
    Runs the differentiable ops (never the kernels), each layer under
    ``torch.utils.checkpoint`` with ``remat``."""
    kind = _kind(cfg)
    x = _build_inputs(cfg, params, batch, compute_dtype)
    dev = x.device
    targets = torch.as_tensor(batch["targets"], device=dev).long()
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=dev)
    kw = dict(remat=remat, train=True)
    aux = None
    if kind == "rwkv":
        state = rwkv_mod.init_rwkv_state(cfg, B, compute_dtype, dev)
        x, _ = _rwkv_stack(cfg, params, x, state, **kw)
    elif kind == "hybrid":
        state = mamba_mod.init_mamba_state(cfg, cfg.n_layers, B,
                                           compute_dtype, dev)
        x, _, _ = _hybrid_stack(cfg, params, x, state, positions, **kw)
    else:
        enc_out, x = _encoder_inputs(cfg, params, batch, x, compute_dtype,
                                     train=True)
        x, aux, _ = _txf_stack(cfg, params, x, positions, enc_out, **kw)
    x = rmsnorm_train(x, params["final_norm"], cfg.norm_eps)
    loss, metrics = chunked_cross_entropy(cfg, params, x, targets)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux / cfg.n_layers
        metrics["aux_loss"] = aux / cfg.n_layers
    return loss, metrics


def _ce_sums(logits: torch.Tensor, targets: torch.Tensor):
    """(sum of the masked nll, of the masked hits, the count of unmasked
    targets): logsumexp in f32 (f64 for f64 logits), the target's logit as
    it is in ``logits``' dtype (the reference's one-hot product accumulated
    in f32 picks it exactly)."""
    mask = (targets >= 0).float()
    tgt = targets.clamp(min=0)
    lg = upcast(logits)
    logz = torch.logsumexp(lg, dim=-1)
    ll = upcast(torch.gather(logits, -1, tgt[..., None])[..., 0])
    nll = torch.sum((logz - ll) * mask)
    acc = torch.sum((torch.argmax(lg, dim=-1) == tgt).float() * mask)
    return nll, acc, mask.sum()


def _ce_chunk(xb: torch.Tensor, tb: torch.Tensor, head: torch.Tensor):
    return _ce_sums(xb @ head, tb)


def chunked_cross_entropy(cfg, params: Params, x: torch.Tensor,
                          targets: torch.Tensor, chunk: int = 512):
    """The reference's sequence-chunked loss (``model.py:407``): the (B,
    chunk, V) logits of one chunk at a time, reduced and dropped, and
    recomputed in backward (each chunk under ``torch.utils.checkpoint``),
    so the (B, S, V) logits never exist; the head is cast to x's dtype once
    and is all that is kept, as ``save_only_these_names("ce_head")``. A
    sequence that is not a multiple of ``chunk``, or no longer than one,
    takes :func:`cross_entropy`."""
    B, S, D = x.shape
    if S % chunk or S <= chunk:
        return cross_entropy(lm_logits(cfg, params, x), targets)
    head = params["embed"]["tok"].T if cfg.tie_embeddings \
        else params["lm_head"]
    head = head.to(x.dtype)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    nll, acc, n = zero, zero, zero
    for c0 in range(0, S, chunk):
        c_nll, c_acc, c_n = checkpointed(
            _ce_chunk, x[:, c0:c0 + chunk], targets[:, c0:c0 + chunk], head)
        nll, acc, n = nll + c_nll, acc + c_acc, n + c_n
    n = torch.clamp(n, min=1.0)
    loss = nll / n
    return loss, {"loss": loss, "acc": acc / n, "tokens": n}


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor):
    """The reference's ``cross_entropy`` (``model.py:451``): logits (B, S,
    V); targets (B, S) integers, -100 masked. Returns (mean loss over the
    unmasked targets, {"loss", "acc", "tokens"})."""
    nll, acc, n = _ce_sums(logits, targets)
    denom = torch.clamp(n, min=1.0)
    loss = nll / denom
    return loss, {"loss": loss, "acc": acc / denom, "tokens": n}


def forward_prefill(cfg, params: Params, batch, compute_dtype=torch.bfloat16):
    """Process a full prompt, ``batch["tokens"]`` (B, S), with
    ``batch["embeds"]`` (vlm) or ``batch["enc_embeds"]`` (audio) where the
    config has them; returns (last-token logits (B, V), cache)."""
    kind = _kind(cfg)
    x = _build_inputs(cfg, params, batch, compute_dtype)
    B, S = x.shape[0], x.shape[1]
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
        enc_out, x = _encoder_inputs(cfg, params, batch, x, compute_dtype)
        x, _, cache = _txf_stack(cfg, params, x, positions, enc_out,
                                 collect_cache=True)
    x = rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, x)[:, 0], cache


def forward_decode(cfg, params: Params, cache, token: torch.Tensor, pos: int,
                   compute_dtype=torch.bfloat16):
    """One decode step. token: (B, 1); pos: the position being written
    (vlm: patches included). Returns (logits (B, 1, V), new cache)."""
    kind = _kind(cfg)
    x = embed_tokens(cfg, params, token, compute_dtype)
    pos = int(pos)
    if cfg.family == "audio":
        # the reference's dynamic_slice clamps the start into the table
        row = min(max(pos, 0), params["pos_emb"].shape[0] - 1)
        x = x + params["pos_emb"][row:row + 1].to(compute_dtype)[None]
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
    dev = resolve_init_device(device)
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
    cache = {"k": torch.zeros((L, batch, Smax, KV, Dh), **kw),
             "v": torch.zeros((L, batch, Smax, KV, Dh), **kw)}
    if cfg.encoder is not None:
        Se = cfg.encoder.enc_seq
        cache["ck"] = torch.zeros((L, batch, Se, KV, Dh), **kw)
        cache["cv"] = torch.zeros((L, batch, Se, KV, Dh), **kw)
    return cache

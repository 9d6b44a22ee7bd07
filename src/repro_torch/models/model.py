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

Under the rules of a mesh with a 'model' axis (the training step,
``train/train_step.py``), ``forward_train`` computes tensor-parallel over
'model' on the compute copy that :func:`compute_model_dims` lays out: each
rank keeps a sequence slice of the residual (the reference's ``res_seq``,
``constrain_residual`` after attention and after the FFN), looks up the
tokens of its vocabulary slice, runs the blocks of ``layers.py``,
``moe.py``, ``mamba2.py`` and ``rwkv6.py`` head-, column/row- or
expert-parallel, and takes the loss vocab-parallel (logsumexp, the
target's logit and the argmax across the ranks). It is one code path:
every block takes the 'model' group (``grp``), and without one (no
mesh) its collectives are the identity. Serving on a mesh
(``serve.make_prefill_step(mesh=)``, ``make_decode_step(mesh=)``) runs
the same blocks with the kernels: prefill on the sequence slice as
training does, the cache returned in ``cache_specs``' layout; decode on
a residual whole on every rank (``n`` None: the row-parallel exits
all-reduce), each rank's slice of the KV cache and its heads of the
recurrent states.

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

from .. import obs
from ..device import resolve_init_device
from . import mamba2 as mamba_mod
from . import rwkv6 as rwkv_mod
from .layers import (attn_heads_split, attention, attention_block,
                     attention_train, cache_kv, checkpointed,
                     decode_attention_block, init_attn, init_mlp, mlp_block,
                     mlp_split, normal_init, rmsnorm, rmsnorm_train, upcast)
from .moe import experts_split, init_moe, moe_mlp

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
                 compute_dtype, grp=None) -> torch.Tensor:
    """The tokens' rows of the table in ``compute_dtype`` (audio: times
    sqrt(d)). With ``grp`` (a table split over its vocabulary) this rank's
    rows, zero for a token another rank holds: a partial sum."""
    table = params["embed"]["tok"]
    if grp is None:
        x = table[tokens].to(compute_dtype)
    else:
        v0 = grp.rank * table.shape[0]
        mine = (tokens >= v0) & (tokens < v0 + table.shape[0])
        x = table[torch.where(mine, tokens - v0, 0)].to(compute_dtype) * \
            mine[..., None].to(compute_dtype)
    if cfg.family != "audio":
        return x
    # sqrt(d) rounded to x's dtype first, as JAX rounds a Python scalar
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)


def _build_inputs(cfg, params: Params, batch, compute_dtype, grp=None):
    """(token embeddings, with the vlm's patch embeddings
    (``batch["embeds"]``, (B, n_patches, D)) prepended; the sequence's
    length). With ``grp`` (tensor-parallel) the embeddings are this rank's
    sequence slice: a vocab-parallel lookup whose partial sums are
    reduce-scattered to the slices (the patch embeddings enter on rank
    0), or, with a table used whole, each rank's slice of the lookup."""
    from ..dist.sharding import scatter_seq, seq_slice
    dev = params["embed"]["tok"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    split = grp is not None and cfg.vocab_size % grp.size == 0
    x = embed_tokens(cfg, params, tokens, compute_dtype,
                     grp if split else None)
    if cfg.vlm is not None and "embeds" in batch:
        e = torch.as_tensor(batch["embeds"], device=dev).to(compute_dtype)
        x = torch.cat([torch.zeros_like(e) if split and grp.rank else e, x],
                      dim=1)
    n = x.shape[1]
    return (scatter_seq(x, grp) if split else seq_slice(x, grp)), n


def _encoder_inputs(cfg, params: Params, batch, x: torch.Tensor, n: int,
                    compute_dtype, train: bool = False, grp=None):
    """For an encoder config: the encoder's output over
    ``batch["enc_embeds"]`` (whole on every rank) and ``x`` with the
    learned positions ``pos_emb[:n]`` added (with ``grp`` its slice of
    them); else (None, x)."""
    from ..dist.sharding import seq_slice
    if cfg.encoder is None:
        return None, x
    enc = torch.as_tensor(batch["enc_embeds"], device=x.device)
    enc_out = _encoder_forward(cfg, params, enc, compute_dtype, train, grp)
    pos = seq_slice(params["pos_emb"][:n], grp, dim=0)
    return enc_out, x + pos.to(compute_dtype)


def lm_logits(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"]["tok"].T if cfg.tie_embeddings \
        else params["lm_head"]
    return x @ head.to(x.dtype)


def _layer(tree, i: int):
    """Layer ``i`` of a tree of stacked ``(L, ...)`` tensors (None: a zero
    state, for every layer)."""
    if tree is None:
        return None
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


def _ffn(cfg, h: torch.Tensor, lp: Params, n: Optional[int] = None,
         grp=None):
    """The layer's MLP, or its MoE and that layer's aux loss (else None);
    ``n`` and ``grp`` as for :func:`_txf_layer`."""
    if "moe" in lp:
        return moe_mlp(h, lp["moe"], cfg, n, grp)
    return mlp_block(cfg, h, lp["mlp"], n, grp), None


def _txf_layer(cfg, x: torch.Tensor, lp: Params, positions: torch.Tensor,
               enc_out: Optional[torch.Tensor] = None, train: bool = False,
               grp=None):
    """One decoder layer (``model.py:140``). Returns (x, the layer's aux
    loss or None, its cache entries: (k, v), and with ``enc_out`` also the
    cross-attention's (kx, vx)). With ``grp`` (tensor-parallel)
    ``x`` is this rank's sequence slice of the residual, whose whole
    sequence has ``positions``: the reference's ``constrain_residual``
    after attention and after the FFN."""
    norm, attend = _ops(train)
    h = norm(x, lp["ln1"], cfg.norm_eps)
    # audio: learned positions, no RoPE
    y, kv = attention_block(cfg, h, lp["attn"], positions, grp,
                            attend=attend, causal=True,
                            window=cfg.sliding_window,
                            rope=cfg.family != "audio")
    x = x + y
    if enc_out is not None:
        # normed with ln2, which the MLP's norm below uses again: the
        # reference's init makes no "ln_x" for its ``"ln_x" in lp`` test
        # (ROADMAP Queue 3, R10)
        h = norm(x, lp["ln2"], cfg.norm_eps)
        y, kvx = attention_block(cfg, h, lp["xattn"], positions, grp,
                                 attend=attend, causal=False, rope=False,
                                 src=enc_out)
        x = x + y
        kv = kv + kvx
    y, aux = _ffn(cfg, norm(x, lp["ln2"], cfg.norm_eps), lp,
                  positions.shape[0], grp)
    return x + y, aux, kv


def _encoder_forward(cfg, params: Params, enc_embeds: torch.Tensor,
                     compute_dtype, train: bool = False,
                     grp=None) -> torch.Tensor:
    """Whisper's encoder (``model.py:168``) over precomputed frame
    embeddings (B, enc_seq, D): non-causal self-attention, the MLP, and
    its own final norm. With ``grp`` each rank runs its sequence slice;
    the output is whole on every rank."""
    from ..dist.sharding import gather_seq, seq_slice
    norm, attend = _ops(train)
    n = enc_embeds.shape[1]
    positions = torch.arange(n, device=enc_embeds.device)
    x = seq_slice(enc_embeds.to(compute_dtype), grp)
    lps = params["encoder"]["layers"]
    for i in range(lps["ln1"].shape[0]):
        lp = _layer(lps, i)
        h = norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attention_block(cfg, h, lp["attn"], positions, grp,
                                attend=attend, causal=False, rope=False)[0]
        h = norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp_block(cfg, h, lp["mlp"], n, grp)
    return gather_seq(norm(x, params["encoder"]["final_norm"], cfg.norm_eps),
                      n, grp)


def _txf_stack(cfg, params: Params, x: torch.Tensor, positions: torch.Tensor,
               enc_out: Optional[torch.Tensor] = None, *,
               remat: bool = False, train: bool = False,
               collect_cache: bool = False, grp=None):
    """x: (B, S, D) through every layer of ``params["layers"]``; positions
    (S,); ``enc_out`` the encoder's output for cross-attention (audio).
    Returns (x, the layers' summed aux loss (f32; f64 for f64 compute),
    cache or None), the cache ``{"k","v": (L, B, S, KV, Dh)}`` (and
    ``"ck","cv": (L, B, enc_seq, KV, Dh)`` with ``enc_out``) when
    ``collect_cache``. ``train``: the differentiable ops; ``remat``: each
    layer under ``torch.utils.checkpoint``; ``grp``: tensor-parallel, x
    this rank's sequence slice (:func:`_txf_layer`)."""
    if _kind(cfg) != "transformer":
        raise ValueError(f"{cfg.name} is not a transformer config")
    aux = torch.zeros((), dtype=torch.promote_types(x.dtype, torch.float32),
                      device=x.device)
    kvs = []

    def layer(x, lp):
        x, a, kv = _txf_layer(cfg, x, lp, positions, enc_out, train, grp)
        if collect_cache and grp is not None:   # the cache's layout
            kv = cache_kv(cfg, kv, positions.shape[0], grp)
        return x, a, (kv if collect_cache else None)
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


def _txf_decode(cfg, params: Params, x: torch.Tensor, cache, pos: int,
                grp=None, seq_lens=None):
    """Single-token decode through the stack, writing the KV cache; with
    the encoder's ``ck``/``cv`` in the cache, each layer also
    cross-attends to all of it. With ``grp`` (the 'model' group of a
    mesh's rules) ``x`` is whole on every rank, the cache this rank's
    slices of caches ``seq_lens["k"]`` and ``seq_lens["ck"]`` long
    (``layers.decode_attention_block``)."""
    from ..dist.sharding import cache_seq_group
    seq_lens = seq_lens or {}
    n = seq_lens.get("k", cache["k"].shape[2])
    cgrp = cache_seq_group(n)
    if "ck" in cache:
        ne = seq_lens.get("ck", cache["ck"].shape[2])
        cgrp_x = cache_seq_group(ne)
    # audio: learned positions, no RoPE
    rope_pos = None if cfg.family == "audio" else \
        torch.tensor([pos], device=x.device)
    for i in range(params["layers"]["ln1"].shape[0]):
        lp = _layer(params["layers"], i)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        x = x + decode_attention_block(cfg, h, lp["attn"], cache["k"][i],
                                       cache["v"][i], pos, grp, cgrp=cgrp,
                                       window=cfg.sliding_window,
                                       rope_pos=rope_pos, n=n)
        if "ck" in cache:
            h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
            x = x + decode_attention_block(cfg, h, lp["xattn"],
                                           cache["ck"][i], cache["cv"][i],
                                           ne - 1, grp, cgrp=cgrp_x, n=ne,
                                           write=False)
        y, _ = _ffn(cfg, rmsnorm(x, lp["ln2"], cfg.norm_eps), lp, None, grp)
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
                remat: bool = False, train: bool = False,
                n: Optional[int] = None, grp=None):
    """Every rwkv layer in turn; returns (x, the new stacked state). A
    state of None is a zero one, and then no state is kept or returned
    (the training forward). ``n`` and ``grp``: tensor-parallel, x this
    rank's sequence slice of a sequence ``n`` long."""
    new = []

    def layer(x, lp, st):
        x, st = rwkv_mod.rwkv_block(x, lp, cfg, st, train, n, grp)
        return x, (None if state is None else st)
    for i in range(params["layers"]["rwkv"]["ln1"].shape[0]):
        args = (x, _layer(params["layers"]["rwkv"], i), _layer(state, i))
        x, st = checkpointed(layer, *args) if remat else layer(*args)
        new.append(st)
    return x, None if state is None else _stack(new)


def _shared_block(cfg, sp: Params, x: torch.Tensor, positions: torch.Tensor,
                  train: bool = False, grp=None):
    """The hybrid's shared attention block; ``grp`` as for
    :func:`_txf_layer`. Returns (x, its (k, v)). One ``shared.block``
    span (``obs``) a call."""
    norm, attend = _ops(train)
    with obs.span("shared.block", x):
        h = norm(x, sp["ln1"], cfg.norm_eps)
        y, kv = attention_block(cfg, h, sp["attn"], positions, grp,
                                attend=attend, causal=True)
        x = x + y
        h = norm(x, sp["ln2"], cfg.norm_eps)
        return x + mlp_block(cfg, h, sp["mlp"], positions.shape[0], grp), kv


def _hybrid_layer(cfg, x, lp, st, sp, positions, shared: bool,
                  train: bool, grp=None):
    """One Mamba2 layer, then the shared block if ``shared``. Returns (x,
    new state, the shared block's (k, v) or None)."""
    x, st = mamba_mod.mamba_block(x, lp, cfg, st, train, positions.shape[0],
                                  grp)
    kv = None
    if shared:
        x, kv = _shared_block(cfg, sp, x, positions, train, grp)
    return x, st, kv


def _hybrid_stack(cfg, params: Params, x: torch.Tensor, state,
                  positions: torch.Tensor, *, remat: bool = False,
                  train: bool = False, collect_cache: bool = False,
                  grp=None):
    """Zamba2: the Mamba2 layers in turn; the shared attention block after
    every ``shared_attn_every``-th. Returns (x, new stacked state, cache or
    None); the cache holds the K/V of the ``n_layers // every`` slots where
    the shared block ran, (n_slots, B, S, KV, Dh), as the reference's
    ``nonzero(flags, size=n_slots)`` selects them. ``train`` and ``remat``
    as for the dense stack (a layer with its shared block is one
    checkpoint); a state of None and ``grp`` as for :func:`_rwkv_stack`."""
    every = cfg.shared_attn_every
    n_slots = cfg.n_layers // every
    sp = params["shared"]
    new, ks, vs = [], [], []

    def layer(x, lp, st, shared):
        x, st, kv = _hybrid_layer(cfg, x, lp, st, sp, positions, shared,
                                  train, grp)
        if collect_cache and kv is not None and grp is not None:
            kv = cache_kv(cfg, kv, positions.shape[0], grp)
        return (x, None if state is None else st,
                kv if collect_cache else None)
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
    return x, None if state is None else _stack(new), cache


def _hybrid_decode(cfg, params: Params, x: torch.Tensor, cache, pos: int,
                   grp=None, seq_lens=None):
    """Single-token decode: the Mamba2 layers on their states, the shared
    block against its slots' KV cache; ``grp`` and ``seq_lens`` as for
    :func:`_txf_decode`."""
    from ..dist.sharding import cache_seq_group
    every = cfg.shared_attn_every
    sp = params["shared"]
    kc_all, vc_all = cache["k"], cache["v"]          # (n_slots, B, Smax, ..)
    n = (seq_lens or {}).get("k", kc_all.shape[2])
    cgrp = cache_seq_group(n)
    rope_pos = torch.tensor([pos], device=x.device)
    new = []
    for i in range(params["layers"]["mamba"]["ln"].shape[0]):
        x, st = mamba_mod.mamba_block(x, _layer(params["layers"]["mamba"], i),
                                      cfg, _layer(cache["state"], i),
                                      grp=grp)
        new.append(st)
        if i % every == every - 1:
            h = rmsnorm(x, sp["ln1"], cfg.norm_eps)
            x = x + decode_attention_block(cfg, h, sp["attn"],
                                           kc_all[i // every],
                                           vc_all[i // every], pos, grp,
                                           cgrp=cgrp, rope_pos=rope_pos,
                                           n=n)
            h = rmsnorm(x, sp["ln2"], cfg.norm_eps)
            x = x + mlp_block(cfg, h, sp["mlp"], None, grp)
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
    ``torch.utils.checkpoint`` with ``remat``; tensor-parallel over the
    'model' group of the active rules (``dist.sharding.tp_group``; the
    module docstring)."""
    from ..dist.sharding import tp_group
    grp = tp_group()
    kind = _kind(cfg)
    x, n = _build_inputs(cfg, params, batch, compute_dtype, grp)
    dev = x.device
    targets = torch.as_tensor(batch["targets"], device=dev).long()
    positions = torch.arange(n, device=dev)
    kw = dict(remat=remat, train=True, grp=grp)
    aux = None
    if kind == "rwkv":
        x, _ = _rwkv_stack(cfg, params, x, None, n=n, **kw)
    elif kind == "hybrid":
        x, _, _ = _hybrid_stack(cfg, params, x, None, positions, **kw)
    else:
        enc_out, x = _encoder_inputs(cfg, params, batch, x, n, compute_dtype,
                                     True, grp)
        x, aux, _ = _txf_stack(cfg, params, x, positions, enc_out, **kw)
    x = rmsnorm_train(x, params["final_norm"], cfg.norm_eps)
    loss, metrics = chunked_cross_entropy(cfg, params, x, targets, grp=grp)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux / cfg.n_layers
        metrics["aux_loss"] = aux / cfg.n_layers
    return loss, metrics


def _ce_sums(logits: torch.Tensor, targets: torch.Tensor, v0: int = 0,
             grp=None):
    """(sum of the masked nll, of the masked hits, the count of unmasked
    targets): logsumexp in f32 (f64 for f64 logits), the target's logit as
    it is in ``logits``' dtype (the reference's one-hot product accumulated
    in f32 picks it exactly). With ``grp`` the logits are this rank's share
    of the vocabulary, from global index ``v0``: the logsumexp, the
    target's logit (on the rank that holds it) and the argmax (the lowest
    global index of the row's largest logit) are taken across the
    ranks."""
    from ..dist.sharding import argmax_vocab, logsumexp_vocab, reduce_model
    mask = (targets >= 0).float()
    tgt = targets.clamp(min=0)
    lg = upcast(logits)
    logz = logsumexp_vocab(lg, grp)
    mine = (tgt >= v0) & (tgt < v0 + logits.shape[-1])
    ll = upcast(torch.gather(logits, -1, torch.where(
        mine, tgt - v0, 0)[..., None])[..., 0]) * mine
    nll = torch.sum((logz - reduce_model(ll, grp)) * mask)
    acc = torch.sum((argmax_vocab(lg, v0, grp) == tgt).float() * mask)
    return nll, acc, mask.sum()


def _ce_chunk(xb: torch.Tensor, tb: torch.Tensor, head: torch.Tensor,
              v0: int = 0, grp=None):
    return _ce_sums(xb @ head, tb, v0, grp)


def chunked_cross_entropy(cfg, params: Params, x: torch.Tensor,
                          targets: torch.Tensor, chunk: int = 512, grp=None):
    """The reference's sequence-chunked loss (``model.py:407``): the (B,
    chunk, V) logits of one chunk at a time, reduced and dropped, and
    recomputed in backward (each chunk under ``torch.utils.checkpoint``),
    so the (B, S, V) logits never exist; the head is cast to x's dtype once
    and is all that is kept, as ``save_only_these_names("ce_head")``.
    Where the reference takes :func:`cross_entropy` (a sequence not a
    multiple of ``chunk``, or no longer than one) this takes chunks all the
    same, the last one short, and reports its unclamped token count.

    With ``grp`` (tensor-parallel) ``x`` is this rank's slice of the final
    residual: where the head splits over the vocabulary the sequence is
    gathered and the loss taken vocab-parallel (:func:`_ce_sums`), else
    each rank takes the sums of its slice with the whole head and they are
    added over the group."""
    from ..dist.sharding import gather_seq, reduce_model, seq_slice
    n = targets.shape[1]
    head = params["embed"]["tok"].T if cfg.tie_embeddings \
        else params["lm_head"]
    head = head.to(x.dtype)
    vocab = grp is not None and cfg.vocab_size % grp.size == 0
    if vocab:
        x, v0, g_ce, g_sum = gather_seq(x, n, grp), grp.rank * \
            head.shape[1], grp, None
    else:
        targets, v0, g_ce, g_sum = seq_slice(targets, grp), 0, None, grp
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    nll, acc, cnt = zero, zero, zero
    for c0 in range(0, x.shape[1], chunk):
        c = checkpointed(_ce_chunk, x[:, c0:c0 + chunk],
                         targets[:, c0:c0 + chunk], head, v0, g_ce)
        nll, acc, cnt = nll + c[0], acc + c[1], cnt + c[2]
    nll, acc, cnt = (reduce_model(v, g_sum) for v in (nll, acc, cnt))
    denom = torch.clamp(cnt, min=1.0)
    loss = nll / denom
    return loss, {"loss": loss, "acc": acc / denom,
                  "tokens": cnt if n % chunk or n <= chunk else denom}


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor):
    """The reference's ``cross_entropy`` (``model.py:451``): logits (B, S,
    V); targets (B, S) integers, -100 masked. Returns (mean loss over the
    unmasked targets, {"loss", "acc", "tokens"})."""
    nll, acc, n = _ce_sums(logits, targets)
    denom = torch.clamp(n, min=1.0)
    loss = nll / denom
    return loss, {"loss": loss, "acc": acc / denom, "tokens": n}


# ---------------------------------------------------------------------------
# the compute copy's layout over 'model'
# ---------------------------------------------------------------------------

def compute_model_dims(cfg, params, tp: int):
    """The tree of ``params``' layout in the training step's compute copy
    over a 'model' of ``tp`` ranks: for each leaf the tensor dim split over
    'model', or None where every rank uses it whole (on its sequence
    slice). Split: the embedding and the head on vocab; attention's
    ``wqkv``/``wq``/``wk``/``wv`` on their output (heads) and ``wo`` on its
    input where :func:`attn_layout` gives "heads"; the MLP's ``w13``/``w1``
    and ``w2`` likewise where it splits; the experts' ``w13``/``w2`` on the
    expert dim; Mamba-2's ``out_proj`` and rwkv's head projections,
    ``wo``, ``wck`` and ``wcv`` where their heads or ``d_ff`` split."""
    from . import mamba2, rwkv6
    heads = attn_heads_split(cfg, tp)
    mlp_ok = mlp_split(cfg.mlp, cfg.d_ff, cfg.tp_fuse, tp)

    def dim(path, w):
        parts = [str(p) for p in path]
        o = 1 if "layers" in parts else 0
        name, last = parts[-1], w.dim() - 1
        if w.dim() - o < 2:
            return None
        if parts[0] == "embed":
            return 0 if w.shape[0] % tp == 0 else None
        if parts[0] == "lm_head":
            return last if w.shape[last] % tp == 0 else None
        if "attn" in parts or "xattn" in parts:
            return None if not heads else (o if name == "wo" else last)
        if "mlp" in parts:
            return None if not mlp_ok else (o if name == "w2" else last)
        if "moe" in parts:
            return o if name != "router" and experts_split(cfg, tp) else None
        if "mamba" in parts:
            return o if name == "out_proj" and \
                mamba2.ssd_heads_split(cfg, tp) else None
        if "rwkv" in parts:
            split = {"wr": last, "wk": last, "wv": last, "wg": last,
                     "wb": last, "wo": o}
            if name in split and rwkv6.rwkv_heads_split(cfg, tp):
                return split[name]
            if name in ("wck", "wcv") and rwkv6.channel_split(cfg, tp):
                return last if name == "wck" else o
        return None

    from .. import tree as tree_util
    return tree_util.map_with_paths(dim, params)


def _state_tp(cfg, grp, split) -> int:
    """The 'model' ranks a recurrent state's heads split over (1: whole)."""
    return grp.size if grp is not None and split(cfg, grp.size) else 1


def forward_prefill(cfg, params: Params, batch, compute_dtype=torch.bfloat16):
    """Process a full prompt, ``batch["tokens"]`` (B, S), with
    ``batch["embeds"]`` (vlm) or ``batch["enc_embeds"]`` (audio) where the
    config has them; returns (last-token logits (B, V), cache).

    Under the rules of a mesh (``serve.make_prefill_step(mesh=)``) it
    computes tensor-parallel over their 'model' group
    (``dist.sharding.tp_group``) on the compute copy, as
    :func:`forward_train` does, with the kernels: each rank a sequence
    slice of the residual, its heads (K5, K6, K7), columns, rows, vocab or
    experts. It returns this rank's share: the logits of its vocabulary
    slice (the last position's row taken to every rank first) and the
    cache laid out as ``launch.specs.cache_specs`` places it (its
    sequence slice of every KV head, its heads of ``wkv`` and ``ssm``)."""
    from ..dist.sharding import last_position, tp_group
    grp = tp_group()
    kind = _kind(cfg)
    x, S = _build_inputs(cfg, params, batch, compute_dtype, grp)
    B = x.shape[0]
    dev = x.device
    positions = torch.arange(S, device=dev)
    if kind == "rwkv":
        state = rwkv_mod.init_rwkv_state(
            cfg, B, compute_dtype, dev,
            _state_tp(cfg, grp, rwkv_mod.rwkv_heads_split))
        x, cache = _rwkv_stack(cfg, params, x, state, n=S, grp=grp)
    elif kind == "hybrid":
        state = mamba_mod.init_mamba_state(
            cfg, cfg.n_layers, B, compute_dtype, dev,
            _state_tp(cfg, grp, mamba_mod.ssd_heads_split))
        x, state, kv = _hybrid_stack(cfg, params, x, state, positions,
                                     collect_cache=True, grp=grp)
        cache = {"state": state, **kv}
    else:
        enc_out, x = _encoder_inputs(cfg, params, batch, x, S, compute_dtype,
                                     grp=grp)
        x, _, cache = _txf_stack(cfg, params, x, positions, enc_out,
                                 collect_cache=True, grp=grp)
    x = rmsnorm(last_position(x, S, grp), params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, x)[:, 0], cache


def forward_decode(cfg, params: Params, cache, token: torch.Tensor, pos: int,
                   compute_dtype=torch.bfloat16, seq_lens=None):
    """One decode step. token: (B, 1); pos: the position being written
    (vlm: patches included). Returns (logits (B, 1, V), new cache).

    Under the rules of a mesh (``serve.make_decode_step(mesh=)``) the
    residual is whole on every rank (one token has no sequence to split):
    column-parallel projections, row-parallel ones all-reduced, the rank's
    heads of the recurrent states, the rank's slice of the KV caches
    (``seq_lens``: their whole lengths, by ``"k"`` and ``"ck"``) joined
    over the cache_seq group, and the logits of its vocabulary slice."""
    from ..dist.sharding import reduce_model, tp_group
    grp = tp_group()
    kind = _kind(cfg)
    split = grp is not None and cfg.vocab_size % grp.size == 0
    x = embed_tokens(cfg, params, token, compute_dtype,
                     grp if split else None)
    if split:
        x = reduce_model(x, grp)
    pos = int(pos)
    if cfg.family == "audio":
        # the reference's dynamic_slice clamps the start into the table
        row = min(max(pos, 0), params["pos_emb"].shape[0] - 1)
        x = x + params["pos_emb"][row:row + 1].to(compute_dtype)[None]
    if kind == "rwkv":
        x, new_cache = _rwkv_stack(cfg, params, x, cache, grp=grp)
    elif kind == "hybrid":
        x, new_cache = _hybrid_decode(cfg, params, x, cache, pos, grp,
                                      seq_lens)
    else:
        x, new_cache = _txf_decode(cfg, params, x, cache, pos, grp, seq_lens)
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

"""Dense transformer layers in PyTorch: RMSNorm, RoPE, GQA/SWA attention,
GELU/SwiGLU MLPs, and their initialisers.

The dense path of ``repro/models/layers.py``. Parameters are plain dicts of
tensors in the reference's layout, so its weights carry over unchanged
(``repro_torch.convert.from_jax``). ``rmsnorm`` and ``attention`` go through
the port's kernels: K4 and K5 on a CUDA tensor, their plain versions on a
CPU tensor. The kernels have no backward, so training runs
``rmsnorm_train`` and ``attention_train`` instead: the reference's XLA
``rmsnorm`` and ``attention`` (with ``_attend_block`` under
``jax.checkpoint``) as torch ops under autograd, the reference's
``jax.checkpoint`` (nothing saveable) being :func:`checkpointed`.

On a mesh the training step computes tensor-parallel over 'model'
(``dist/sharding.py``): given the 'model' group, :func:`attention_block`,
:func:`mlp` and :func:`mlp_block` take this rank's sequence slice of the
residual and return its slice of the block's output, with the collectives
at the reference's constraint sites (the identity without a group, so
prefill, decode and the one-device step run the same code). Attention
splits its heads (column-parallel ``wqkv``, split through ``split_fused``
with no collective; row-parallel ``wo``) where :func:`attn_layout` allows,
and otherwise (the reference's "q" choice) attends from the rank's query
positions with whole weights; the MLP is column- then row-parallel where
its fused ``w13`` splits, else whole on the sequence slice.

Serving on a mesh adds :func:`cache_kv` (a prefill's keys and values to
the cache's sequence slice of every KV head) and
:func:`decode_attention_block` (one token against the rank's slice of the
cache, the softmax joined over the ranks that hold the cache).
"""
from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import functools
import math
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# rmsnorm(x, scale, eps) is K4 and attention(q, k, v, *, causal, window,
# q_offset) is K5 in the model's (B, S, H, Dh) layout. Unlike the
# reference's, this attention runs any Sq: the reference asserts
# Sq % 2048 == 0 above 2048 query rows.
from ..device import resolve_init_device
from ..kernels.flash_attention import flash_attention_op as attention
from ..kernels.flash_attention.flash_attention import softmax_scale
from ..kernels.rmsnorm import rmsnorm

__all__ = ["rmsnorm", "rope_freqs", "apply_rope", "attention",
           "rmsnorm_train", "attention_train", "checkpointed", "upcast",
           "decode_attention", "decode_attention_block", "cache_kv",
           "split_fused", "qkv_fusable", "attn_qkv",
           "attn_out", "mlp", "normal_init", "draws_through", "init_attn",
           "init_mlp", "attn_layout", "attention_block", "mlp_split",
           "mlp_block"]


# Query-chunk size of the training attention, the reference's ATTN_CHUNK
ATTN_CHUNK = 2048


# ---------------------------------------------------------------------------
# the training path: the reference's XLA functions under autograd
# ---------------------------------------------------------------------------

def upcast(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32 (the reference's ``astype(float32)``), or in float64
    if it is float64: a float64 forward, the f64 reference of a gradient
    check, stays float64 throughout; bf16 and f32 take float32, as
    before."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def checkpointed(fn, *args):
    """``fn(*args)``, its intermediates recomputed in backward rather than
    saved: ``jax.checkpoint`` with nothing saveable. Nothing on the model's
    path draws random numbers, so no RNG state is kept."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def rmsnorm_train(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """The reference's model rmsnorm (``repro/models/layers.py:46``): the
    mean of squares accumulated in f32, ``r`` cast to x's dtype before the
    multiply, ``(x * r) * scale`` in x's dtype."""
    xf = upcast(x)
    var = torch.sum(xf * xf, -1) / x.shape[-1]
    r = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return (x * r) * scale.to(x.dtype)


def _attend_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """The reference's ``_attend_block`` (``layers.py:94-111``). q: (B, Cq,
    KV, G, Dh); k, v: (B, Sk, KV, Dh); mask: (Cq, Sk) or None. Scores in
    f32 from exact products, masked to -1e30, softmax in f32, the
    probabilities rounded to v's dtype before P.V. Returns (B, Cq, KV, G,
    Dh)."""
    scores = torch.einsum("biegd,bjed->begij", upcast(q), upcast(k)) * scale
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("begij,bjed->biegd", probs, v)


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                 window: Optional[int], causal: bool
                 ) -> Optional[torch.Tensor]:
    if not causal and window is None:
        return None
    m = None
    if causal:
        m = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        w = (q_pos[:, None] - k_pos[None, :]) < window
        m = w if m is None else (m & w)
    return m


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, chunk: int = ATTN_CHUNK,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The reference's ``attention`` (``layers.py:126-170``) for training.
    q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh); GQA as a group dim (k and v
    are never repeated). The queries go in blocks of ``chunk`` rows, each
    block under :func:`checkpointed`, so backward recomputes its scores and
    probabilities rather than keeping the (chunk, Sk) probabilities. Unlike
    the reference, which asserts ``Sq % chunk == 0`` above ``chunk`` rows,
    the last block may be short. ``scale``: the scores' factor (None: 1 /
    sqrt(Dh))."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = softmax_scale(Dh, scale)
    qg = q.reshape(B, Sq, KV, G, Dh)
    k_pos = torch.arange(Sk, device=q.device)
    out = []
    for c0 in range(0, Sq, chunk):
        qb = qg[:, c0:c0 + chunk]
        q_pos = torch.arange(qb.shape[1], device=q.device) + (c0 + q_offset)
        mask = _causal_mask(q_pos, k_pos, window, causal)
        out.append(checkpointed(_attend_block, qb, k, v, mask, scale))
    return torch.cat(out, dim=1).reshape(B, Sq, H, Dh)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rope_freqs_np(d_head: int, theta: float) -> np.ndarray:
    powf = ctypes.CDLL(ctypes.util.find_library("m")).powf
    powf.argtypes = [ctypes.c_float, ctypes.c_float]
    powf.restype = ctypes.c_float
    ex = np.arange(0, d_head, 2, dtype=np.float32) / np.float32(d_head)
    return np.array([powf(np.float32(theta), -e) for e in ex], np.float32)


def rope_freqs(d_head: int, theta: float) -> torch.Tensor:
    """``1 / theta ** (arange(0, d_head, 2) / d_head)`` in float32, with the
    bits the reference's compiled model uses. XLA folds that expression into
    one constant, ``pow(theta, -i/d_head)`` evaluated by the C library's
    ``powf``; so does this. torch's and numpy's float32 ``pow`` differ from
    it in the last bit at some indices, and at position 180,000 one bit of a
    frequency moves the angle by up to 0.006 rad."""
    return torch.from_numpy(_rope_freqs_np(d_head, float(theta)).copy())


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, ..., Dh); positions: (S,). Rotate-half RoPE in f32 (f64
    for an f64 x, with the f32 angles), the result in x's dtype."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta).to(x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    mid = x.dim() - angles.dim() - 1
    angles = angles.reshape(angles.shape[:-1] + (1,) * mid
                            + angles.shape[-1:])
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(upcast(x), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention of one new token against a cache
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     window: Optional[int] = None, grp=None, offset: int = 0,
                     n: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against a (possibly longer-than-pos) cache.

    q: (B, 1, H, Dh); caches: (B, Smax, KV, Dh); pos: the position of the
    new token (cache entries > pos are masked out). With ``window`` the
    cache is a ring of length Smax == window: once it has wrapped (pos >=
    Smax) every slot is valid. Plain torch, as the reference computes it in
    XLA (no Pallas kernel): scores in f32, masked to -1e30, the
    probabilities rounded to the cache's dtype before P.V.

    The softmax is taken in the form that joins across ranks: the largest
    score, the sum of exp(score - largest), then P.V of the probabilities
    rounded to the cache's dtype, in f32. With ``grp`` (the cache_seq
    group, ``dist.sharding.cache_seq_group``) the caches are this rank's
    slice, from position ``offset``, of a cache ``n`` long: each of the
    three is joined over the ranks (``dist.sharding.combine``); without
    one the combine is the identity, so one device and any mesh run the
    same arithmetic. ``scale``: the scores' factor (None: 1 / sqrt(Dh)).
    """
    B, _, H, Dh = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    n = Smax if n is None else n
    G = H // KV
    scale = softmax_scale(Dh, scale)
    qg = q.reshape(B, 1, KV, G, Dh)
    k_pos = torch.arange(Smax, device=q.device) + offset
    valid = k_pos <= pos
    if window is not None and pos >= n:
        valid = torch.ones_like(valid)
    scores = torch.einsum("biegd,bjed->begij", qg.float(),
                          k_cache.float()) * scale
    scores = torch.where(valid, scores, -1e30)
    from ..dist.sharding import combine
    p = torch.exp(scores - combine(scores.amax(-1, keepdim=True), grp,
                                   "max"))
    probs = (p / combine(p.sum(-1, keepdim=True), grp)).to(v_cache.dtype)
    out = combine(torch.einsum("begij,bjed->biegd", probs.float(),
                               v_cache.float()), grp)
    return out.to(v_cache.dtype).reshape(B, 1, H, Dh)


def decode_attention_block(cfg, h: torch.Tensor, p, kc: torch.Tensor,
                           vc: torch.Tensor, pos: int, grp=None, *,
                           cgrp=None, window: Optional[int] = None,
                           rope_pos: Optional[torch.Tensor] = None,
                           n: Optional[int] = None,
                           write: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One token's attention (the normed residual ``h`` (B, 1, D)) against
    its layer's cache ``kc``, ``vc`` (B, S_c, KV, Dh) of a cache ``n``
    positions long (None: ``kc``'s own length): projections, RoPE at
    ``rope_pos`` ((1,), ``pos`` on the device, made once a step; None: no
    RoPE), the new key and value written into the cache in
    place at ``pos`` (a ring's ``pos % n`` with ``window``; without
    ``write``, a cross-attention's cache, only q is projected and nothing
    written), :func:`decode_attention` (at ``scale``) and ``wo``. Returns
    the block's output (B, 1, D).

    With ``grp`` (the 'model' group; the residual whole on every rank)
    and the heads split (:func:`attn_layout`), the rank's columns of
    ``wqkv`` (or ``wq``/``wk``/``wv``) are gathered to every head in one
    all-gather, since every rank scores every head against its slice of
    the cache, and ``wo`` is row-parallel on the rank's heads, its partial
    sums all-reduced; otherwise the weights are whole. ``cgrp`` is the
    cache's group under the active rules' ``cache_seq``
    (``dist.sharding.cache_seq_group(n)``, worked out once a step; None:
    the cache whole on this rank): the cache is this rank's slice of it,
    written only by the rank that holds the position."""
    from ..dist.sharding import gather_parts, reduce_model
    n = kc.shape[1] if n is None else n
    B = h.shape[0]
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    heads = grp is not None and attn_heads_split(cfg, grp.size)
    tp = grp.size if heads else 1
    names = ("wq", "wk", "wv") if write else ("wq",)
    if "wqkv" in p:
        parts = split_fused(_proj(h, p["wqkv"]),
                            [H * Dh // tp, KV * Dh // tp, KV * Dh // tp],
                            max(cfg.tp_fuse // tp, 1))[:len(names)]
    else:
        parts = [_proj(h, p[w]) for w in names]
    if heads:
        parts = gather_parts(parts, grp)
    q, *kv = (t.reshape(B, 1, -1, Dh) for t in parts)
    if rope_pos is not None:
        q = apply_rope(q, rope_pos, cfg.rope_theta)
    s0 = 0 if cgrp is None else cgrp.bounds(n)[0]
    at = pos % n if window is not None else pos
    if write and s0 <= at < s0 + kc.shape[1]:
        k, v = kv
        if rope_pos is not None:
            k = apply_rope(k, rope_pos, cfg.rope_theta)
        kc[:, at - s0] = k[:, 0].to(kc.dtype)
        vc[:, at - s0] = v[:, 0].to(vc.dtype)
    o = decode_attention(q, kc, vc, pos, window=window, grp=cgrp,
                         offset=s0, n=n, scale=scale)
    if not heads:
        return attn_out(o, p)
    Hl = H // tp
    o = o[:, :, grp.rank * Hl:(grp.rank + 1) * Hl].reshape(B, 1, Hl * Dh)
    return reduce_model(_proj(o, p["wo"]), grp)


def cache_kv(cfg, kv, n_q: int, grp):
    """The (k, v) :func:`attention_block` returned with ``grp`` for a
    sequence of ``n_q`` queries, laid out as the cache holds them under
    the active rules: this rank's slice of the key sequence by
    ``cache_seq`` (``dist.sharding.cache_seq_group``; whole where the
    guard keeps it whole) of every KV head. From the "heads" layout (the
    rank's KV heads, a KV head rebuilt on tp / KV ranks kept once) one
    all-to-all over 'model'; from "seq" (whole keys and values on every
    rank) a slice."""
    from ..dist.sharding import cache_seq_group, kv_heads_to_seq, seq_slice
    tp = grp.size
    heads = attn_layout(cfg, tp, attn_choice(cfg, tp, n_q)) == "heads"
    rep = 1 if cfg.n_kv_heads % tp == 0 else tp // cfg.n_kv_heads
    return tuple(kv_heads_to_seq(t, grp, cache_seq_group(t.shape[1]), rep)
                 if heads else seq_slice(t, cache_seq_group(t.shape[1]))
                 for t in kv)


# ---------------------------------------------------------------------------
# projections / MLP
# ---------------------------------------------------------------------------

def split_fused(x: torch.Tensor, widths: Sequence[int],
                interleave: int) -> List[torch.Tensor]:
    """Split the last dim of ``x`` into ``widths``, where the fused dim is
    laid out in ``interleave`` blocks of [w0/t | w1/t | ...]."""
    t = interleave
    if t <= 1 or any(w % t for w in widths):
        return list(torch.split(x, list(widths), dim=-1))
    tot = x.shape[-1]
    xr = x.reshape(x.shape[:-1] + (t, tot // t))
    parts, off = [], 0
    for w in widths:
        parts.append(xr[..., off:off + w // t].reshape(x.shape[:-1] + (w,)))
        off += w // t
    return parts


def qkv_fusable(cfg) -> bool:
    """Whether the reference fuses q/k/v into one ``wqkv`` (H, H*Dh and
    KV*Dh all divide ``tp_fuse``)."""
    t = cfg.tp_fuse
    return (t > 1 and cfg.n_heads % t == 0
            and (cfg.n_heads * cfg.d_head) % t == 0
            and (cfg.n_kv_heads * cfg.d_head) % t == 0)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def _tp(grp) -> int:
    return 1 if grp is None else grp.size


def _own_kv(k: torch.Tensor, cfg, grp) -> torch.Tensor:
    """(B, S, KV_r, Dh): the KV heads of this rank's query heads, from its
    columns of k: whole heads where tp divides KV, else its KV head
    rebuilt from the tp / KV ranks that hold a slice of its Dh."""
    from ..dist.sharding import gather_model
    B, S, _ = k.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if KV % _tp(grp) == 0:
        return k.reshape(B, S, KV // _tp(grp), Dh)
    j = (grp.rank * (H // grp.size)) // (H // KV)
    whole = gather_model(k, grp)
    return whole[..., j * Dh:(j + 1) * Dh].reshape(B, S, 1, Dh)


def attn_qkv(x: torch.Tensor, p, cfg, grp=None):
    """x: (B, S, D) -> q (B,S,H,Dh), k and v (B,S,KV,Dh). With ``grp``
    (tensor-parallel, the weights column-parallel: this rank's columns of
    ``wqkv``, split through ``split_fused`` with no collective, or of
    ``wq``/``wk``/``wv``) this rank's H/tp query heads and the KV heads
    they use."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    tp = _tp(grp)
    if "wqkv" in p:
        q, k, v = split_fused(_proj(x, p["wqkv"]),
                              [H * Dh // tp, KV * Dh // tp, KV * Dh // tp],
                              max(cfg.tp_fuse // tp, 1))
    else:
        q, k, v = (_proj(x, p[n]) for n in ("wq", "wk", "wv"))
    return (q.reshape(B, S, H // tp, Dh), _own_kv(k, cfg, grp),
            _own_kv(v, cfg, grp))


def attn_out(o: torch.Tensor, p, grp=None) -> torch.Tensor:
    """o: (B, S, H, Dh) -> (B, S, D). With ``grp`` (``wo`` row-parallel,
    ``o`` this rank's heads over the whole sequence) this rank's sequence
    slice of the sum over the ranks."""
    from ..dist.sharding import scatter_seq
    B, S = o.shape[:2]
    return scatter_seq(_proj(o.reshape(B, S, -1), p["wo"]), grp)


def mlp(x: torch.Tensor, p, kind: str = "swiglu", fuse: int = 1, grp=None,
        n: Optional[int] = None) -> torch.Tensor:
    """The MLP. With ``grp`` (its weights column- then row-parallel,
    :func:`mlp_split`) ``x`` is this rank's sequence slice of a sequence
    ``n`` long, gathered in, and the result its slice of the output, the
    partial sums reduce-scattered out; with ``n`` None (a decode step)
    ``x`` is whole on every rank and the partial sums are all-reduced."""
    from ..dist.sharding import gather_seq, leave_block
    x = gather_seq(x, n, grp)
    if kind == "swiglu":
        gu = _proj(x, p["w13"])
        gate, up = split_fused(gu, [gu.shape[-1] // 2] * 2,
                               max(fuse // _tp(grp), 1))
        h = F.silu(gate) * up
    else:  # gelu: jax.nn.gelu's default is the tanh approximation
        h = F.gelu(_proj(x, p["w1"]), approximate="tanh")
    return leave_block(_proj(h, p["w2"]), n, grp)


# ---------------------------------------------------------------------------
# the attention block, with and without tensor-parallel compute
# ---------------------------------------------------------------------------

def attn_layout(cfg, tp: int, choice: Optional[str]) -> str:
    """"heads" or "seq": how attention runs over a 'model' of ``tp`` ranks,
    given the reference's ``attn_shard_choice``. "heads" where the choice
    is None (tp factors over (KV, G)) or names a head dim, the query heads
    split evenly in order, each rank's query heads share KV heads it holds
    whole or one KV head split over tp / KV ranks (rebuilt before the
    scores, never a split contraction), and a fused ``wqkv`` splits into
    each part's own columns. Otherwise ("q", or nothing fits) "seq": the
    rank's query positions against every key, with whole weights."""
    from ..dist.sharding import fused_split_ok
    if choice == "q":
        return "seq"
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    ok = H % tp == 0 and (KV % tp == 0 or (
        tp % KV == 0 and (H // KV) % (tp // KV) == 0))
    if qkv_fusable(cfg):
        ok = ok and fused_split_ok([H * Dh, KV * Dh, KV * Dh], cfg.tp_fuse,
                                   tp)
    return "heads" if ok else "seq"


def attn_heads_split(cfg, tp: int) -> bool:
    """Whether attention splits its heads over a 'model' of ``tp`` ranks
    (the compute copy's layout; :func:`attn_layout` does not depend on the
    query length)."""
    return attn_layout(cfg, tp, attn_choice(cfg, tp, ATTN_CHUNK)) == "heads"


def attn_choice(cfg, tp: int, q_len: int) -> Optional[str]:
    """The reference's ``attn_shard_choice`` for ``cfg``'s heads."""
    from ..dist import sharding
    return sharding.attn_shard_choice(cfg.n_kv_heads,
                                      cfg.n_heads // cfg.n_kv_heads,
                                      min(q_len, ATTN_CHUNK), tp)


def attention_block(cfg, h: torch.Tensor, p, positions: torch.Tensor,
                    grp=None, *, attend=attention_train, causal: bool = True,
                    window: Optional[int] = None, rope: bool = True,
                    src: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None):
    """Attention of the normed residual ``h`` (B, s, D), whose whole
    sequence has ``positions`` (n,): projections, RoPE (``rope``),
    ``attend`` (:func:`attention_train`, or the kernel K5) and ``wo``.
    ``src`` (B, n_src, D) is a cross-attention's key and value input;
    ``scale`` the scores' factor (None: ``attend``'s own, 1 / sqrt(Dh)).
    Returns (the output (B, s, D), the (k, v) attended to).

    With ``grp`` ``h`` is this rank's sequence slice, ``src`` whole on
    every rank, and the output this rank's slice. Where
    :func:`attn_layout` gives "heads" the sequence is gathered, the rank's
    heads attend (``attn_qkv``'s column-parallel split) and ``wo``
    row-parallel reduce-scatters; otherwise ("seq") the rank's query
    positions attend to the gathered keys and values with whole
    weights."""
    from ..dist.sharding import gather_seq
    n = positions.shape[0]
    tp = _tp(grp)
    if attn_layout(cfg, tp, attn_choice(cfg, tp, n)) == "heads":
        hf = gather_seq(h, n, grp)
        q, k, v = attn_qkv(hf, p, cfg, grp)
        if src is not None:
            _, k, v = attn_qkv(src, p, cfg, grp)
        if rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        o = attend(q, k, v, causal=causal, window=window, scale=scale)
        return attn_out(o, p, grp), (k, v)
    s0, s1 = grp.bounds(n)
    q, k, v = attn_qkv(h, p, cfg)
    if src is not None:
        _, k, v = attn_qkv(src, p, cfg)
    if rope:
        q = apply_rope(q, positions[s0:s1], cfg.rope_theta)
        k = apply_rope(k, positions[s0:s1], cfg.rope_theta)
    if src is None:
        k, v = gather_seq(k, n, grp), gather_seq(v, n, grp)
    o = attend(q, k, v, causal=causal, window=window, q_offset=s0,
               scale=scale)
    return attn_out(o, p), (k, v)


def mlp_split(kind: str, d_ff: int, fuse: int, tp: int) -> bool:
    """Whether the MLP runs column- then row-parallel over ``tp`` ranks
    (else whole on the sequence slice): a SwiGLU's fused ``w13`` must
    split into gate and up columns."""
    from ..dist.sharding import fused_split_ok
    if kind == "swiglu":
        return fused_split_ok([d_ff, d_ff], fuse, tp)
    return d_ff % tp == 0


def mlp_block(cfg, h: torch.Tensor, p, n: Optional[int] = None,
              grp=None) -> torch.Tensor:
    """:func:`mlp` of the normed residual ``h`` with ``cfg``'s kind: with
    ``grp`` column- then row-parallel where :func:`mlp_split` allows, else
    whole on this rank's sequence slice."""
    if grp is not None and not mlp_split(cfg.mlp, cfg.d_ff, cfg.tp_fuse,
                                         grp.size):
        grp = None
    return mlp(h, p, cfg.mlp, cfg.tp_fuse, grp, n)


# ---------------------------------------------------------------------------
# init helpers: drawn on the CPU from a torch.Generator, then moved, so one
# seed gives the same weights on every device (``None`` means ``cuda``)
# ---------------------------------------------------------------------------

_DRAWS = threading.local()


@contextlib.contextmanager
def draws_through(fn):
    """Within the block, every leaf :func:`normal_init` makes (a meta
    stand-in on ``meta``) is passed to ``fn`` as soon as it is drawn, and
    ``fn``'s return takes its place in the tree. A sharded init keeps only
    its rank's slice, and the whole leaf is freed before the next is
    drawn; the generator's stream does not change."""
    prev = getattr(_DRAWS, "fn", None)
    _DRAWS.fn = fn
    try:
        yield
    finally:
        _DRAWS.fn = prev


def normal_init(gen: torch.Generator, shape, scale: float = 0.02,
                dtype=torch.float32, device=None) -> torch.Tensor:
    dev = resolve_init_device(device)
    if dev.type == "meta":                  # a shape-only tree: no draw
        w = torch.empty(tuple(shape), dtype=dtype, device=dev)
    else:                                   # scaled in place: one leaf
        w = torch.randn(tuple(shape), generator=gen,
                        dtype=torch.float32).mul_(scale)
        w = w.to(device=dev, dtype=dtype)
    fn = getattr(_DRAWS, "fn", None)
    return w if fn is None else fn(w)


def init_attn(gen: torch.Generator, cfg, n_layers: Optional[int] = None,
              dtype=torch.float32, device=None):
    """Stacked attention params (fused qkv where the reference fuses)."""
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    L = () if n_layers is None else (n_layers,)
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    kw = dict(dtype=dtype, device=device)
    if qkv_fusable(cfg):
        return {"wqkv": normal_init(gen, L + (D, (H + 2 * KV) * Dh), **kw),
                "wo": normal_init(gen, L + (H * Dh, D), out_scale, **kw)}
    return {"wq": normal_init(gen, L + (D, H * Dh), **kw),
            "wk": normal_init(gen, L + (D, KV * Dh), **kw),
            "wv": normal_init(gen, L + (D, KV * Dh), **kw),
            "wo": normal_init(gen, L + (H * Dh, D), out_scale, **kw)}


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             kind: str = "swiglu", n_layers: Optional[int] = None,
             n_scale_layers: int = 24, dtype=torch.float32, device=None):
    L = () if n_layers is None else (n_layers,)
    out_scale = 0.02 / math.sqrt(2 * n_scale_layers)
    kw = dict(dtype=dtype, device=device)
    wide = 2 * d_ff if kind == "swiglu" else d_ff
    w_in = normal_init(gen, L + (d_model, wide), **kw)
    p = {"w2": normal_init(gen, L + (d_ff, d_model), out_scale, **kw)}
    p["w13" if kind == "swiglu" else "w1"] = w_in
    return p

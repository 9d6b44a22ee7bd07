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
``jax.checkpoint`` (nothing saveable) being :func:`checkpointed`. The reference's
sharding constraints (``constrain*``) are dropped: on a mesh the port
computes on the gathered copy of the weights (``train/train_step.py``),
so no activation is sharded.
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
from ..kernels.rmsnorm import rmsnorm

__all__ = ["rmsnorm", "rope_freqs", "apply_rope", "attention",
           "rmsnorm_train", "attention_train", "checkpointed", "upcast",
           "decode_attention", "split_fused", "qkv_fusable", "attn_qkv",
           "attn_out", "mlp", "normal_init", "draws_through", "init_attn",
           "init_mlp"]


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
                    q_offset: int = 0, chunk: int = ATTN_CHUNK
                    ) -> torch.Tensor:
    """The reference's ``attention`` (``layers.py:126-170``) for training.
    q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh); GQA as a group dim (k and v
    are never repeated). The queries go in blocks of ``chunk`` rows, each
    block under :func:`checkpointed`, so backward recomputes its scores and
    probabilities rather than keeping the (chunk, Sk) probabilities. Unlike
    the reference, which asserts ``Sq % chunk == 0`` above ``chunk`` rows,
    the last block may be short."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(Dh)
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
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against a (possibly longer-than-pos) cache.

    q: (B, 1, H, Dh); caches: (B, Smax, KV, Dh); pos: the position of the
    new token (cache entries > pos are masked out). With ``window`` the
    cache is a ring of length Smax == window: once it has wrapped (pos >=
    Smax) every slot is valid. Plain torch, as the reference computes it in
    XLA (no Pallas kernel): scores in f32, masked to -1e30, the
    probabilities rounded to the cache's dtype before P.V.
    """
    B, _, H, Dh = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, 1, KV, G, Dh)
    k_pos = torch.arange(Smax, device=q.device)
    valid = k_pos <= pos
    if window is not None and pos >= Smax:
        valid = torch.ones_like(valid)
    scores = torch.einsum("biegd,bjed->begij", qg.float(),
                          k_cache.float()) * scale
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("begij,bjed->biegd", probs, v_cache)
    return out.reshape(B, 1, H, Dh)


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


def attn_qkv(x: torch.Tensor, p, cfg):
    """x: (B, S, D) -> q (B,S,H,Dh), k and v (B,S,KV,Dh)."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if "wqkv" in p:
        q, k, v = split_fused(_proj(x, p["wqkv"]), [H * Dh, KV * Dh, KV * Dh],
                              cfg.tp_fuse)
    else:
        q, k, v = (_proj(x, p[n]) for n in ("wq", "wk", "wv"))
    return (q.reshape(B, S, H, Dh), k.reshape(B, S, KV, Dh),
            v.reshape(B, S, KV, Dh))


def attn_out(o: torch.Tensor, p) -> torch.Tensor:
    B, S, H, Dh = o.shape
    return _proj(o.reshape(B, S, H * Dh), p["wo"])


def mlp(x: torch.Tensor, p, kind: str = "swiglu",
        fuse: int = 1) -> torch.Tensor:
    if kind == "swiglu":
        gu = _proj(x, p["w13"])
        gate, up = split_fused(gu, [gu.shape[-1] // 2] * 2, fuse)
        h = F.silu(gate) * up
    else:  # gelu: jax.nn.gelu's default is the tanh approximation
        h = F.gelu(_proj(x, p["w1"]), approximate="tanh")
    return _proj(h, p["w2"])


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

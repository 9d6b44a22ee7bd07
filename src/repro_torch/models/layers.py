"""Dense transformer layers in PyTorch: RMSNorm, RoPE, GQA/SWA attention,
GELU/SwiGLU MLPs, and their initialisers.

The dense path of ``repro/models/layers.py``. Parameters are plain dicts of
tensors in the reference's layout, so its weights carry over unchanged
(``repro_torch.convert.from_jax``). ``rmsnorm`` and ``attention`` go through
the port's kernels: K4 and K5 on a CUDA tensor, their plain versions on a
CPU tensor. The reference's sharding constraints (``constrain*``) are the
identity without a mesh and are dropped.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# rmsnorm(x, scale, eps) is K4 and attention(q, k, v, *, causal, window,
# q_offset) is K5 in the model's (B, S, H, Dh) layout. Unlike the
# reference's, this attention runs any Sq: the reference asserts
# Sq % 2048 == 0 above 2048 query rows.
from ..device import resolve_device
from ..kernels.flash_attention import flash_attention_op as attention
from ..kernels.rmsnorm import rmsnorm

__all__ = ["rmsnorm", "rope_freqs", "apply_rope", "attention",
           "decode_attention", "split_fused", "qkv_fusable", "attn_qkv",
           "attn_out", "mlp", "normal_init", "init_attn", "init_mlp"]


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
    """x: (B, S, ..., Dh); positions: (S,). Rotate-half RoPE in f32, the
    result in x's dtype."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta).to(x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    mid = x.dim() - angles.dim() - 1
    angles = angles.reshape(angles.shape[:-1] + (1,) * mid
                            + angles.shape[-1:])
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
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

def normal_init(gen: torch.Generator, shape, scale: float = 0.02,
                dtype=torch.float32, device=None) -> torch.Tensor:
    w = scale * torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    return w.to(device=resolve_device(device), dtype=dtype)


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
